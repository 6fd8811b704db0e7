#!/usr/bin/env python3
"""Ablations of the streaming window-attention kernels on the card.

    python3 tools/ablate_window_attention.py [VARIANT ...]

Copies ``iseg_tpu_torch`` into ``_checkout/ablate/<variant>/`` (git-ignored)
with one change to ``csrc/window_attention.cu`` each, builds every copy in
parallel, then times each copy in a process of its own, twice, in turns
(the variants in order, then in reverse), with ``chip_smoke.py``'s timers:
the profiler's device time of the forward and of the backward at the
streaming rows below, the minimum of the two runs printed. A variant whose
change no longer applies to the source raises. Needs a CUDA card; the
results of an ablated copy are wrong by design and only its times count.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "_checkout" / "ablate"
SOURCE = "iseg_tpu_torch/csrc/window_attention.cu"


def _swap(old: str, new: str, count: int = 0):
    def apply(src: str) -> str:
        found = src.count(old)
        if not found or (count and found != count):
            raise ValueError(f"the ablation no longer applies: {old[:60]!r} found {found} times")
        return src.replace(old, new)
    return apply


ZERO_BM = "for (int u_ = 0; u_ < 2; ++u_) for (int e_ = 0; e_ < 4; ++e_) bm[u_][e_] = 0.f;"
VARIANTS = {
    "base": lambda src: src,
    # one chain of products over the head dim in the f32 forward too
    "one_chain": _swap("float (&dst)[2][4] = kTwoChains && c % 2 == 1 ? odd : s;",
                       "float (&dst)[2][4] = s;", count=2),
    # every tile 64 rows (window 12 then ends in a tile of 16 keys)
    "tile64": _swap("return (N + 47) / 48 * 48 - N < (N + 63) / 64 * 64 - N ? 48 : 64;",
                    "return 64;"),
    # f32 operands split at every use instead of once a step
    "no_presplit": _swap("  return sizeof(T) == 4 && D <= 64;\n", "  return false;\n"),
    # one TF32 product instead of three (wrong results: the split's cost)
    "no_split": _swap("""  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);""", "  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);"),
    # no bias or mask read (wrong results: their reads' cost)
    "no_bias_mask": lambda src: _swap(
        "stream_bias_mask(bm, bias_h, mask_b, query, r0, N, true);", ZERO_BM)(_swap(
        "stream_bias_mask(bm, bias_h, mask_b, key, r0, N, false);", ZERO_BM)(src)),
    # no dbias sums (wrong dbias: the sums' cost)
    "no_dbias_sums": lambda src: _swap(
        "                *at = b == b_first ? ds : *at + ds;", "")(_swap(
        "            if (sums_smem) slot[(u * 4 + e) * blockDim.x] += ds;\n", "")(src)),
}

# (bnw, H, windows per image, window, D, dtype name): phase 2's streaming rows
ROWS = {
    "f32 N=144 D=36": (72, 12, 9, 12, 36, "float32"),
    "f32 N=144 D=64": (72, 12, 9, 12, 64, "float32"),
    "bf16 N=144 D=64": (72, 12, 9, 12, 64, "bfloat16"),
    "bf16 N=256 D=32 stage0": (512, 6, 64, 16, 32, "bfloat16"),
    "bf16 N=256 D=32 stage2": (32, 24, 4, 16, 32, "bfloat16"),
}

CHILD = r'''
import json, math, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
import chip_smoke as cs
from iseg_tpu_torch.ops.kernels import _build
from iseg_tpu_torch.ops.kernels import window_attention as wa
assert wa.__file__.startswith(sys.argv[1]), wa.__file__
built = _build.load(wa.SOURCE)
if sys.argv[3] == "build":
    print(json.dumps({"build_s": built.seconds}))
    sys.exit(0)
device = torch.device("cuda")
row = {}
for name, (bnw, heads, nw, window, d, dtype) in json.loads(sys.argv[4]).items():
    q, k, v, dout, bias, mask = cs.wa_inputs(device, bnw, heads, nw, True, getattr(torch, dtype),
                                             window=window, d=d)
    scale = 1 / math.sqrt(d)
    reps = dict(reps=10, warmup=2)
    with torch.no_grad():
        row[name + " fwd"] = cs.device_ms(
            lambda _: wa.window_attention(q, k, v, bias, mask, scale), **reps)
    row[name + " bwd"] = cs.wa_backward_ms(wa.window_attention, q, k, v, dout, bias, mask, scale,
                                           timer=cs.device_ms, **reps)
    del q, k, v, dout, bias, mask
    torch.cuda.empty_cache()
print(json.dumps(row))
'''


def main(names: list[str]) -> int:
    names = names or list(VARIANTS)
    trees = {}
    for name in names:
        tree = OUT / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(ROOT / "iseg_tpu_torch", tree / "iseg_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = tree / SOURCE
        src.write_text(VARIANTS[name](src.read_text()))
        trees[name] = str(tree)
    child = OUT / "child.py"
    child.write_text(CHILD)
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen([sys.executable, str(child), t, str(ROOT), "build"],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for n, t in trees.items()}
    for n, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"{n}: build failed\n{err[-3000:]}")
    print(f"built {len(trees)} copies in parallel in {time.perf_counter() - t0:.1f} s", flush=True)
    runs: dict[str, list[dict]] = {}
    for order in (names, names[::-1]):
        for n in order:
            res = subprocess.run([sys.executable, str(child), trees[n], str(ROOT), "time",
                                  json.dumps(ROWS)], capture_output=True, text=True, timeout=900)
            if res.returncode:
                raise RuntimeError(f"{n}: timing failed\n{res.stderr[-3000:]}")
            runs.setdefault(n, []).append(json.loads(res.stdout.strip().splitlines()[-1]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"device ms, the lesser of two runs ({card}):")
    for n, rs in runs.items():
        print(f"{n:14s}", "  ".join(f"{k}: {min(r[k] for r in rs):.4f}" for k in rs[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
