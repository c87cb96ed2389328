"""Dev script: build variants of csrc/flash_bwd_sm90.cu, check them and
time them in turns.

    python scripts_dev/flash_bwd_variants.py NAME=[@SOURCE] [NVCC FLAGS] ...

Run from the repository root on a machine with one H100, e.g.

    python scripts_dev/flash_bwd_variants.py cur= new=@build/new.cu
    git show HEAD:src/repro_torch/kernels/csrc/flash_bwd_sm90.cu \
        > build/parent_flash_bwd_sm90.cu
    python scripts_dev/flash_bwd_variants.py \
        parent=@build/parent_flash_bwd_sm90.cu cur=

Each NAME is built as ``scripts_dev/variants.py`` says into ``build/dev/``
(its ptxas lines and each kernel's highest SASS register printed,
beside the forward's; its SASS written to
``chiprun_out/sass_bwd_NAME.txt`` and each kernel instance's
instructions compared with the first variant's instance of the same
widths), checked against ``ref.attention_bwd_ref`` within
``ref.FLASH_BWD_RTOL`` at ragged, offset, windowed (rows that see no
key: dq 0 there), GQA 1/3/4 and non-causal cases at hd 64 and 128 and
at q/k 192 against v 128 (MLA's widths; a source whose entry has no
``hdv`` takes one width and is checked at those cases only), twice
bitwise, held bitwise against the first variant at every case both
take, and its sha256 at ``chip_smoke.ONE_WIDTH_CASES`` printed; then
profiled once (device time by kernel) and timed with
``chip_smoke.time_ms`` in two rounds (the order reversed in the second)
beside the first design (``csrc/flash_bwd.cu``) and SDPA's backward at
the training path's shape (B = 8, S = 4,096, 9/3 heads of 64), at
Qwen3-4B's prefill shape (B = 4, S = 4,096, 32/8 heads of 128) and at
DeepSeek-V2-Lite's (B = 4, S = 4,096, 16 heads, 192/128), causal bf16.
A variant whose check fails is still timed when its name starts with
``diag``.  Prints the card's nvidia-smi name and power limit last.
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

ROOT = vs.ROOT

# (q shape, k shape, v width, masking)
CASES = [((2, 100, 6, 64), (2, 100, 2, 64), 64, dict(causal=True)),
         ((1, 77, 4, 128), (1, 333, 4, 128), 128,
          dict(causal=True, q_offset=256)),
         ((2, 130, 8, 128), (2, 500, 2, 128), 128,
          dict(causal=True, window=200, q_offset=370)),
         ((1, 64, 8, 128), (1, 1000, 2, 128), 128, dict(causal=False)),
         ((2, 300, 9, 64), (2, 300, 3, 64), 64, dict(causal=True)),
         ((1, 24, 4, 64), (1, 20, 2, 64), 64,
          dict(causal=True, window=3, q_offset=19)),
         ((3, 70, 6, 128), (3, 90, 2, 128), 128,
          dict(causal=True, window=33, q_offset=25)),
         ((2, 150, 16, 64), (2, 190, 16, 64), 64, dict(causal=False)),
         ((8, 4096, 9, 64), (8, 4096, 3, 64), 64, dict(causal=True)),
         ((4, 4096, 32, 128), (4, 4096, 8, 128), 128, dict(causal=True)),
         ((1, 300, 16, 192), (1, 300, 16, 192), 128, dict(causal=True)),
         ((2, 130, 8, 192), (2, 257, 2, 192), 128,
          dict(causal=True, window=96, q_offset=100)),
         ((2, 77, 16, 192), (2, 333, 4, 192), 128,
          dict(causal=True, q_offset=256)),
         ((1, 90, 6, 192), (1, 70, 3, 192), 128, dict(causal=False)),
         ((1, 100, 16, 192), (1, 60, 2, 192), 128,
          dict(causal=True, window=20, q_offset=50)),
         ((2, 4096, 16, 192), (2, 4096, 16, 192), 128, dict(causal=True))]
# (q shape, k shape, v width) timed
PATHS = {"train path": ((8, 4096, 9, 64), (8, 4096, 3, 64), 64),
         "qwen3_4b prefill": (*cs.BWD_QWEN, 128),
         "deepseek prefill": (*cs.BWD_MLA, cs.MLA_V)}


# name: whether the variant's entry takes v's width (an older source's
# takes one width and is bound here with one int64 fewer)
_HDV = {}


def run(fn, hdv_arg, q, k, v, out, lse, g, causal, window=0, q_offset=0):
    """One call of a variant's flash_bwd_sm90 entry (kbwd.launch's)."""
    B, Sq, H, hd = q.shape
    Sk, KVH, hdv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    sqp = -(-Sq // kbwd.SM90_ROWS) * kbwd.SM90_ROWS
    delta = torch.empty((B, H, 2, sqp), dtype=torch.float32, device=q.device)
    widths = (hd, hdv) if hdv_arg else (hd,)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KVH, *widths,
             int(causal), window, q_offset, 1,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_bwd_sm90")
    return dq, dk, dv


def instances(sass: str):
    """{(kernel, hd, hdv): [SASS instructions]} of each backward kernel in
    a cuobjdump listing; a one-width template (an older source) is read
    as hd = hdv, and stats_kernel's one width as (hdv, hdv)."""
    out, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?(dkdv_kernel|dq_kernel|stats_kernel)"
                      r"ILi(\d+)E(?:Li(\d+)E)?", line)
        if m:
            key = (m.group(1), int(m.group(2)),
                   int(m.group(3) or m.group(2)))
            out[key] = []
        elif "Function :" in line:
            key = None
        elif key:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", line)
            if m:
                out[key].append(m.group(1))
    return out


def sass_registers(sass: str):
    """{kernel: highest register index in its SASS}."""
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


def cuobjdump(path: str) -> str:
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True).stdout


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


def build(variants):
    """{name: (entry, takes hdv)} of each variant that builds, its SASS
    written and compared as the docstring above says."""
    for name, flags in variants.items():
        flags = flags.split()
        src = flags[0][1:] if flags and flags[0].startswith("@") else \
            str(_build.CSRC / "flash_bwd_sm90.cu")
        entry = open(src).read()
        entry = entry[entry.index('extern "C" int flash_bwd_sm90('):]
        _HDV[name] = "int64_t hdv" in entry[:entry.index("{")]
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    for k, r in sass_registers(cuobjdump(str(_build._target(
            "flash_sm90")))).items():
        print(f"  sass flash_sm90 (forward): {k[:90]} highest register R{r}")
    fns, first = {}, None
    for name, lib in vs.build("flash_bwd_sm90", variants).items():
        fn = lib.flash_bwd_sm90
        if not _HDV[name]:
            fn.argtypes = fn.argtypes[:16] + fn.argtypes[17:]
        fns[name] = (fn, _HDV[name])
        sass = cuobjdump(lib._name)
        (ROOT / "chiprun_out" / f"sass_bwd_{name}.txt").write_text(sass)
        for k, r in sass_registers(sass).items():
            print(f"  sass {name}: {k[:90]} highest register R{r}")
        ins = instances(sass)
        if first is None:
            first = (name, ins)
            continue
        for key, code in sorted(ins.items()):
            prev = first[1].get(key)
            same = "no instance there" if prev is None else (
                "identical" if prev == code else
                f"{sum(a != b for a, b in zip(prev, code))} of "
                f"{min(len(prev), len(code))} differ")
            print(f"  sass {name} {key}: {len(code)} instructions; against "
                  f"{first[0]}'s: {same}")
    return fns


def main(argv):
    _build.build_all(["flash_sm90", "flash_bwd"])
    fns = build(vs.parse(argv))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    inputs = []
    for q_shape, kv_shape, hdv, kw in CASES:
        q, k = rand(q_shape), rand(kv_shape)
        v, g = rand(kv_shape[:3] + (hdv,)), rand(q_shape[:3] + (hdv,))
        inputs.append((q, k, v, g, kw))
    first = {}    # case index: the first variant's (name, grads)
    timed = []
    for name, (fn, hdv_arg) in fns.items():
        ok, same = True, True
        for i, (q, k, v, g, kw) in enumerate(inputs):
            if not hdv_arg and q.shape[3] != v.shape[3]:
                continue
            out, lse = kflash.flash_cuda(q, k, v, **kw, return_lse=True)
            got = again = None
            try:
                got = run(fn, hdv_arg, q, k, v, out, lse, g, **kw)
                again = run(fn, hdv_arg, q, k, v, out, lse, g, **kw)
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
                print(f"  {name} {tuple(q.shape)}/{k.shape[2]} "
                      f"{q.shape[3]}/{v.shape[3]} {kw}: max abs err {e:.3e} "
                      f"(v1 {e1:.3e}), blind rows {int(blind.sum())}, two "
                      "calls bitwise")
                if i not in first:
                    first[i] = (name, got)
                elif not all(torch.equal(a, b)
                             for a, b in zip(got, first[i][1])):
                    same = False
                    print(f"  {name} {tuple(q.shape)} {kw}: differs from "
                          f"{first[i][0]}'s at " + ", ".join(
                              f"{n} {int((a != b).sum())}" for n, a, b in
                              zip(("dq", "dk", "dv"), got, first[i][1])))
            except (AssertionError, RuntimeError) as err:
                ok = False
                print(f"  {name} {tuple(q.shape)}/{k.shape[2]} {kw}: "
                      f"{str(err)[:400]}")
            del out, lse, got, again
            torch.cuda.empty_cache()
        for label, h in cs.one_width_sha256(
                lambda *a, fn=fn, hv=hdv_arg, **kw: run(fn, hv, *a, **kw)
                ).items():
            print(f"  {name} one width {label}: sha256 {h}")
        print(name, "correct" if ok else "wrong",
              "(bitwise the first variant at every case both take)"
              if same else "(differs from the first variant)")
        if ok or name.startswith("diag"):
            timed.append(name)
    del inputs, first
    torch.cuda.empty_cache()

    for label, (q_shape, kv_shape, hdv) in PATHS.items():
        q, k = rand(q_shape), rand(kv_shape)
        v, g = rand(kv_shape[:3] + (hdv,)), rand(q_shape[:3] + (hdv,))
        out, lse = kflash.flash_cuda(q, k, v, causal=True, return_lse=True)
        names = [n for n in timed if fns[n][1] or hdv == q_shape[3]]
        fn_of = {n: (lambda f, hv: lambda: run(f, hv, q, k, v, out, lse, g,
                                                True))(*fns[n])
                 for n in names}
        fn_of["v1"] = lambda: kbwd.launch("flash_bwd", q, k, v, out, lse, g,
                                          causal=True)
        try:
            fn_of["SDPA backward"] = cs.sdpa_bwd(q, k, v, g)
            fn_of["SDPA backward"]()
        except RuntimeError as exc:
            print(f"  SDPA's backward refuses {label}: {str(exc)[:200]}")
            fn_of.pop("SDPA backward", None)
        for n in names:
            profile(fn_of[n], f"{n} {label}")
        times = vs.rounds(fn_of, 2)
        b_ms, b_by, n_ops = cs.flash_bwd_bound(q_shape, kv_shape, hdv)
        print(f"{label} {q_shape}/{kv_shape[2]} v{hdv} causal, bound "
              f"{b_ms:.3f} ms by {b_by}:")
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
