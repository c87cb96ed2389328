"""Dev script: build variants of csrc/flash_sm90.cu and time them in turns.

    python scripts_dev/flash_variants.py NAME=[@SOURCE] [NVCC FLAGS] ...

Run from the repository root on a machine with one H100, e.g.

    python scripts_dev/flash_variants.py cur= other=-DSOME_MACRO

Each NAME is built with nvcc (the flags of ``kernels/_build.py`` plus
the given ones; ``@path`` builds another source) into ``build/dev/``,
its SASS written to ``chiprun_out/sass_NAME.txt``, checked against
``ref.attention_ref`` at ragged, offset, windowed, GQA and non-causal
cases, then timed with ``chip_smoke.time_ms`` in three rounds (the
order reversed in the second) beside flash.cu's PR-14 kernel and SDPA
at the LM forward's shape (B = 4, S = 4,096, 32/8 heads of 128, bf16,
causal), and once more non-causal at S = 4,096 and causal at B = 1,
S = 16,384.  A variant whose check fails is still timed when its name
starts with ``diag`` (a variant that leaves out part of the work on
purpose).  Prints the card's nvidia-smi name and power limit last.
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash as kflash  # noqa: E402

CASES = [((2, 100, 6, 64), (2, 100, 2, 64), dict(causal=True)),
         ((2, 130, 8, 128), (2, 500, 2, 128),
          dict(causal=True, window=200, q_offset=370)),
         ((1, 77, 4, 128), (1, 333, 4, 128), dict(causal=True, q_offset=256)),
         ((1, 64, 8, 128), (1, 1000, 2, 128), dict(causal=False)),
         ((2, 1500, 9, 64), (2, 1500, 3, 64), dict(causal=True)),
         ((1, 600, 8, 128), (1, 300, 2, 128),
          dict(causal=True, window=40, q_offset=700)),
         ((3, 700, 16, 64), (3, 900, 16, 64), dict(causal=False)),
         ((4, 4096, 32, 128), (4, 4096, 8, 128), dict(causal=True))]


def build(variants):
    nvcc = _build.nvcc_path()
    out_dir = ROOT / "build" / "dev"
    out_dir.mkdir(parents=True, exist_ok=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        flags = flags.split()
        src = str(_build.CSRC / "flash_sm90.cu")
        if flags and flags[0].startswith("@"):
            src = flags.pop(0)[1:]
        so = out_dir / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(so), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if any(w in line for w in ("C75", "registers", "spill", "error")):
                print(name, line.strip()[:200])
        if proc.returncode:
            print(name, "build failed")
            continue
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
             str(so)], capture_output=True, text=True).stdout
        (ROOT / "chiprun_out" / f"sass_{name}.txt").write_text(sass)
        fn = getattr(ctypes.CDLL(str(so)), "flash_sm90_fwd")
        fn.argtypes = _build._SIGNATURES["flash_sm90"]["flash_sm90_fwd"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(fn, q, k, v, causal, window=0, q_offset=0):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = fn(*kflash.launch_args(q, k, v, out, causal=causal, window=window,
                                 q_offset=q_offset, source="flash_sm90"),
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_sm90_fwd")
    return out


def main(argv):
    variants = dict(a.split("=", 1) for a in argv)
    fns = build(variants)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    timed = []
    for name, fn in fns.items():
        ok = True
        for q_shape, kv_shape, kw in CASES:
            q, k, v = rand(*q_shape), rand(*kv_shape), rand(*kv_shape)
            out = run(fn, q, k, v, **kw)
            torch.cuda.synchronize()
            try:
                ref.check_attention(out, q, k, v, **kw)
            except AssertionError as e:
                ok = False
                print(name, q_shape, kv_shape, kw, str(e)[:160])
        print(name, "correct" if ok else "wrong")
        if ok or name.startswith("diag"):
            timed.append(name)

    B, S = cs.LM_PREFILL
    q, k, v = rand(B, S, 32, 128), rand(B, S, 8, 128), rand(B, S, 8, 128)
    b_ms, b_by, n_ops = cs.flash_bound(q.shape, k.shape)
    fn_of = {n: (lambda f: lambda: run(f, q, k, v, True))(fns[n])
             for n in timed}
    fn_of["flash (PR 14)"] = lambda: kflash.launch("flash", q, k, v,
                                                   causal=True)
    fn_of["SDPA"] = lambda: cs.sdpa(q, k, v)
    times = {n: [] for n in fn_of}
    for rnd in range(3):
        for n in (list(fn_of) if rnd % 2 == 0 else list(fn_of)[::-1]):
            times[n].append(cs.time_ms(fn_of[n]))
    print(f"b{B} s{S} h32/8 hd128 causal, bound {b_ms:.3f} ms by {b_by}:")
    for n, t in times.items():
        med = sorted(t)[1]
        print(f"  {n}: {', '.join(f'{x:.4f}' for x in t)} ms; median "
              f"{med:.4f} ({n_ops / med / 1e9:.1f} TFLOP/s)")
    del q, k, v
    for label, (b, s, causal) in {"noncausal b4 s4096": (4, 4096, False),
                                  "causal b1 s16384": (1, 16384, True)
                                  }.items():
        q, k, v = rand(b, s, 32, 128), rand(b, s, 8, 128), rand(b, s, 8, 128)
        pairs = s * s if not causal else s * (s + 1) // 2
        ops = 4 * b * 32 * 128 * pairs
        for n in timed + ["SDPA"]:
            if n == "SDPA":
                f = (lambda c: lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=c, enable_gqa=True))(causal)
            else:
                f = (lambda fn, c: lambda: run(fn, q, k, v, c))(fns[n],
                                                                causal)
            t = cs.time_ms(f)
            print(f"  {label} {n}: {t:.4f} ms ({ops / t / 1e9:.1f} TFLOP/s)")
        del q, k, v
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
