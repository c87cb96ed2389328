"""Dev script: build variants of csrc/flash_sm90.cu and time them in turns.

    python scripts_dev/flash_variants.py NAME=[@SOURCE] [NVCC FLAGS] ...

Run from the repository root on a machine with one H100, e.g.

    python scripts_dev/flash_variants.py cur= other=-DSOME_MACRO
    git show HEAD:src/repro_torch/kernels/csrc/flash_sm90.cu \
        > build/parent_flash_sm90.cu
    python scripts_dev/flash_variants.py \
        parent=@build/parent_flash_sm90.cu cur=

Each NAME is built as ``scripts_dev/variants.py`` says into ``build/dev/``,
its SASS written to ``chiprun_out/sass_NAME.txt``, checked against
``ref.attention_ref`` at ragged, offset, windowed, GQA and non-causal
cases at hd 64 and 128, and at q/k 192 against v 128 (MLA's widths,
where a variant built from an older source may refuse them), each
output and its lse held bitwise against the first variant's, and each
kernel instance's SASS instructions against the first variant's
instance of the same widths, then timed with ``chip_smoke.time_ms`` in
three rounds (the order reversed in the second) beside flash.cu's PR-14
kernel and SDPA at the LM forward's shape (B = 4, S = 4,096, 32/8 heads
of 128, bf16, causal), once more non-causal at S = 4,096 and causal
at B = 1, S = 16,384, and at MLA's prefill (B = 4, S = 4,096, 16 heads,
192/128, causal) beside flash.cu's 192/128 kernel and SDPA.  A variant
whose check fails is still timed when its name starts with ``diag`` (a
variant that leaves out part of the work on purpose).  Prints the
card's nvidia-smi name and power limit last.
"""
import os
import re
import subprocess
import sys

import variants as vs  # first: puts the repo's sources on sys.path

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash as kflash  # noqa: E402

ROOT = vs.ROOT

# (q shape, k shape, v width, masking)
CASES = [((2, 100, 6, 64), (2, 100, 2, 64), 64, dict(causal=True)),
         ((2, 130, 8, 128), (2, 500, 2, 128), 128,
          dict(causal=True, window=200, q_offset=370)),
         ((1, 77, 4, 128), (1, 333, 4, 128), 128,
          dict(causal=True, q_offset=256)),
         ((1, 64, 8, 128), (1, 1000, 2, 128), 128, dict(causal=False)),
         ((2, 1500, 9, 64), (2, 1500, 3, 64), 64, dict(causal=True)),
         ((1, 600, 8, 128), (1, 300, 2, 128), 128,
          dict(causal=True, window=40, q_offset=700)),
         ((3, 700, 16, 64), (3, 900, 16, 64), 64, dict(causal=False)),
         ((4, 4096, 32, 128), (4, 4096, 8, 128), 128, dict(causal=True)),
         ((1, 300, 16, 192), (1, 300, 16, 192), 128, dict(causal=True)),
         ((2, 130, 8, 192), (2, 257, 2, 192), 128,
          dict(causal=True, window=96, q_offset=100)),
         ((1, 90, 6, 192), (1, 70, 3, 192), 128, dict(causal=False)),
         ((4, 4096, 16, 192), (4, 4096, 16, 192), 128, dict(causal=True))]


def instances(sass: str):
    """{(hd, hdv): [SASS instructions]} of each flash_sm90_kernel in a
    cuobjdump listing; a one-width template (an older source) is read as
    hd = hdv."""
    out, key = {}, None
    for line in sass.splitlines():
        m = re.search(
            r"Function : \S*flash_sm90_kernelILi(\d+)E(?:Li(\d+)E)?", line)
        if m:
            key = (int(m.group(1)), int(m.group(2) or m.group(1)))
            out[key] = []
        elif "Function :" in line:
            key = None
        elif key:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", line)
            if m:
                out[key].append(m.group(1))
    return out


def build(variants):
    """{name: flash_sm90_fwd} of each variant that builds, its SASS
    written as the docstring above says; each instance's instructions
    compared with the first variant's instance of the same widths."""
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    fns, first = {}, None
    for name, lib in vs.build("flash_sm90", variants).items():
        sass = subprocess.run([cuobjdump, "-sass", lib._name],
                              capture_output=True, text=True).stdout
        (ROOT / "chiprun_out" / f"sass_{name}.txt").write_text(sass)
        fns[name] = lib.flash_sm90_fwd
        ins = instances(sass)
        if first is None:
            first = (name, ins)
            continue
        for widths, code in sorted(ins.items()):
            prev = first[1].get(widths)
            same = "no instance there" if prev is None else (
                "identical" if prev == code else
                f"{sum(a != b for a, b in zip(prev, code))} of "
                f"{min(len(prev), len(code))} differ")
            print(f"  sass {name} {widths}: {len(code)} instructions; "
                  f"against {first[0]}'s: {same}")
    return fns


def run(fn, q, k, v, causal, window=0, q_offset=0, lse=None):
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                      device=q.device)
    err = fn(*kflash.launch_args(q, k, v, out, causal=causal, window=window,
                                 q_offset=q_offset, source="flash_sm90",
                                 lse=lse),
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_sm90_fwd")
    return out


def main(argv):
    fns = build(vs.parse(argv))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    inputs = [(rand(*q), rand(*kv), rand(*kv[:3], hdv), kw)
              for q, kv, hdv, kw in CASES]
    first = {}    # case index: the first variant's (out, lse)
    timed, mla = [], []
    for name, fn in fns.items():
        ok, wide, same = True, True, True
        for i, (q, k, v, kw) in enumerate(inputs):
            lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                              device="cuda")
            try:
                out = run(fn, q, k, v, **kw, lse=lse)
                torch.cuda.synchronize()
            except RuntimeError as e:
                if q.shape[3] == v.shape[3]:
                    raise
                wide = False       # an older source: one width only
                print(name, tuple(q.shape), "refused:", str(e)[:120])
                continue
            try:
                ref.check_attention(out, q, k, v, **kw)
                ref.check_lse(lse, q, k, v, **kw)
            except AssertionError as e:
                ok = False
                print(name, tuple(q.shape), tuple(k.shape), kw, str(e)[:160])
            if i not in first:
                first[i] = (name, out, lse)
            elif not (torch.equal(out, first[i][1])
                      and torch.equal(lse, first[i][2])):
                same = False
                print(f"{name} {tuple(q.shape)} {kw}: out differs from "
                      f"{first[i][0]}'s at "
                      f"{int((out != first[i][1]).sum())} elements, lse at "
                      f"{int((lse != first[i][2]).sum())}")
        print(name, "correct" if ok else "wrong",
              "(bitwise the first variant at every case both take)"
              if same else "(differs from the first variant)")
        if ok or name.startswith("diag"):
            timed.append(name)
            if wide:
                mla.append(name)
    del inputs, first

    B, S = cs.LM_PREFILL
    q, k, v = rand(B, S, 32, 128), rand(B, S, 8, 128), rand(B, S, 8, 128)
    b_ms, b_by, n_ops = cs.flash_bound(q.shape, k.shape)
    fn_of = {n: (lambda f: lambda: run(f, q, k, v, True))(fns[n])
             for n in timed}
    fn_of["flash (PR 14)"] = lambda: kflash.launch("flash", q, k, v,
                                                   causal=True)
    fn_of["SDPA"] = lambda: cs.sdpa(q, k, v)
    times = vs.rounds(fn_of, 3)
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
    q, k = rand(B, S, 16, 192), rand(B, S, 16, 192)
    v = rand(B, S, 16, 128)
    b_ms, b_by, n_ops = cs.flash_bound(q.shape, k.shape, 128)
    fn_of = {n: (lambda f: lambda: run(f, q, k, v, True))(fns[n])
             for n in mla}
    fn_of["flash.cu 192/128"] = lambda: kflash.launch("flash", q, k, v,
                                                      causal=True)
    fn_of["SDPA"] = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True)
    times = vs.rounds(fn_of, 3)
    print(f"b{B} s{S} h16 192/128 causal, bound {b_ms:.3f} ms by {b_by}:")
    for n, t in times.items():
        med = sorted(t)[1]
        print(f"  {n}: {', '.join(f'{x:.4f}' for x in t)} ms; median "
              f"{med:.4f} ({n_ops / med / 1e9:.1f} TFLOP/s)")
    del q, k, v
    print(vs.card())


if __name__ == "__main__":
    main(sys.argv[1:])
