"""Dev script: build variants of csrc/flash_bwd_sm90.cu, check them and
time them in turns.

    python scripts_dev/flash_bwd_variants.py NAME=[@SOURCE] [NVCC FLAGS] ...

Run from the repository root on a machine with one H100, e.g.

    python scripts_dev/flash_bwd_variants.py cur= new=@build/new.cu

Each NAME is built as ``scripts_dev/variants.py`` says into ``build/dev/``
(its ptxas lines and each kernel's highest SASS register printed,
beside the forward's), checked against ``ref.attention_bwd_ref``
within ``ref.FLASH_BWD_RTOL`` at ragged, offset, windowed (rows that see
no key: dq 0 there), GQA 1/3/4 and non-causal cases, twice bitwise, then
profiled once (device time by kernel) and timed with
``chip_smoke.time_ms`` in two rounds (the order reversed in the second)
beside the first design (``csrc/flash_bwd.cu``) and SDPA's
backward at the training path's shape (B = 8, S = 4,096, 9/3 heads of
64) and at Qwen3-4B's prefill shape (B = 4, S = 4,096, 32/8 heads of
128), causal bf16.  A variant whose check fails is still timed when
its name starts with ``diag``.  Prints the card's nvidia-smi name and
power limit last.
"""
import os
import re
import subprocess
import sys

import variants as vs  # first: puts the repo's sources on sys.path

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash as kflash  # noqa: E402
from repro_torch.kernels import flash_bwd as kbwd  # noqa: E402

CASES = [((2, 100, 6, 64), (2, 100, 2, 64), dict(causal=True)),
         ((1, 77, 4, 128), (1, 333, 4, 128), dict(causal=True, q_offset=256)),
         ((2, 130, 8, 128), (2, 500, 2, 128),
          dict(causal=True, window=200, q_offset=370)),
         ((1, 64, 8, 128), (1, 1000, 2, 128), dict(causal=False)),
         ((2, 300, 9, 64), (2, 300, 3, 64), dict(causal=True)),
         ((1, 24, 4, 64), (1, 20, 2, 64),
          dict(causal=True, window=3, q_offset=19)),
         ((3, 70, 6, 128), (3, 90, 2, 128),
          dict(causal=True, window=33, q_offset=25)),
         ((2, 150, 16, 64), (2, 190, 16, 64), dict(causal=False)),
         ((8, 4096, 9, 64), (8, 4096, 3, 64), dict(causal=True)),
         ((4, 4096, 32, 128), (4, 4096, 8, 128), dict(causal=True))]
PATHS = {"train path": ((8, 4096, 9, 64), (8, 4096, 3, 64)),
         "qwen3_4b prefill": cs.BWD_QWEN}


def run(fn, q, k, v, out, lse, g, causal, window=0, q_offset=0):
    """One call of a variant's flash_bwd_sm90 entry (kbwd.launch's)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    sqp = -(-Sq // kbwd.SM90_ROWS) * kbwd.SM90_ROWS
    delta = torch.empty((B, H, 2, sqp), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KVH, hd,
             int(causal), window, q_offset, 1,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_bwd_sm90")
    return dq, dk, dv


def sass_registers(lib_path: str):
    """{kernel: highest register index in its SASS} of a built library."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = -1
        elif name:
            for r in re.findall(r"\bR(\d+)\b", line):
                out[name] = max(out[name], int(r))
    return out


def profile(fn, label):
    """Device time by kernel of one call of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3) for e in p.key_averages()
            if e.device_time_total > 0]
    print(f"  profile {label}: " + "; ".join(
        f"{k[:60]} {t:.3f} ms" for k, t in sorted(rows, key=lambda r: -r[1])))


def main(argv):
    _build.build_all(["flash_sm90", "flash_bwd"])
    libs = vs.build("flash_bwd_sm90", vs.parse(argv))
    fns = {n: lib.flash_bwd_sm90 for n, lib in libs.items()}
    for k, r in sass_registers(str(_build._target("flash_sm90"))).items():
        print(f"  sass flash_sm90 (forward): {k[:90]} highest register R{r}")
    for n, lib in libs.items():
        for k, r in sass_registers(lib._name).items():
            print(f"  sass {n}: {k[:90]} highest register R{r}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    timed = []
    for name, fn in fns.items():
        ok = True
        for q_shape, kv_shape, kw in CASES:
            q, k, v, g = (rand(s) for s in (q_shape, kv_shape, kv_shape,
                                            q_shape))
            out, lse = kflash.flash_cuda(q, k, v, **kw, return_lse=True)
            got = again = None
            try:
                got = run(fn, q, k, v, out, lse, g, **kw)
                again = run(fn, q, k, v, out, lse, g, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError("two calls differ")
                blind = torch.isinf(lse).transpose(1, 2)   # (B, Sq, H)
                if (got[0][blind] != 0).any():
                    raise AssertionError("dq is not 0 where a row sees no "
                                         "key")
                e = ref.check_attention_bwd(got, q, k, v, out, lse, g, **kw,
                                            what=name)
                prev = kbwd.launch("flash_bwd", q, k, v, out, lse, g,
                                   **kw)
                e1 = ref.check_attention_bwd(prev, q, k, v, out, lse, g,
                                             **kw, what="v1")
                print(f"  {name} {q_shape}/{kv_shape[2]} {kw}: max abs err "
                      f"{e:.3e} (v1 {e1:.3e}), blind rows "
                      f"{int(blind.sum())}, two calls bitwise")
            except (AssertionError, RuntimeError) as err:
                ok = False
                print(f"  {name} {q_shape}/{kv_shape[2]} {kw}: "
                      f"{str(err)[:400]}")
            del q, k, v, g, out, lse, got, again
            torch.cuda.empty_cache()
        print(name, "correct" if ok else "wrong")
        if ok or name.startswith("diag"):
            timed.append(name)

    for label, (q_shape, kv_shape) in PATHS.items():
        q, k, v, g = (rand(s) for s in (q_shape, kv_shape, kv_shape,
                                        q_shape))
        out, lse = kflash.flash_cuda(q, k, v, causal=True, return_lse=True)
        fn_of = {n: (lambda f: lambda: run(f, q, k, v, out, lse, g, True))(
            fns[n]) for n in timed}
        fn_of["v1"] = lambda: kbwd.launch("flash_bwd", q, k, v, out, lse, g,
                                          causal=True)
        fn_of["SDPA backward"] = cs.sdpa_bwd(q, k, v, g)
        for n in timed:
            profile(fn_of[n], f"{n} {label}")
        times = vs.rounds(fn_of, 2)
        b_ms, b_by, n_ops = cs.flash_bwd_bound(q_shape, kv_shape)
        print(f"{label} {q_shape}/{kv_shape[2]} causal, bound {b_ms:.3f} ms "
              f"by {b_by}:")
        for n, t in times.items():
            m = sum(t) / len(t)
            print(f"  {n}: {', '.join(f'{x:.4f}' for x in t)} ms; mean "
                  f"{m:.4f} ({n_ops / m / 1e9:.1f} TFLOP/s, {b_ms / m:.3f} "
                  "of the bound)")
        del q, k, v, g, out, lse, fn_of
        torch.cuda.empty_cache()
    print(vs.card())


if __name__ == "__main__":
    main(sys.argv[1:])
