#!/usr/bin/env python3
"""Ablations of the global-attention kernel pair on the card.

    python3 tools/ablate_global_attention.py [VARIANT ...]

Copies ``iseg_tpu_torch`` into ``_checkout/ablate_ga/<variant>/``
(git-ignored) with one change to ``csrc/global_attention.cu`` each, builds
every copy in parallel, then times each copy in a process of its own, twice,
in turns (the variants in order, then in reverse), with ``chip_smoke.py``'s
timers: the profiler's device time of the forward and of the backward at
phase 2's global rows (ViT-L, EVA02-L patch-dropped, MOAT-4 stage 2, and
MOAT-4 stage 2 with its relative bias on the bias form, dbias formed, in
bf16; ViT-L and the biased MOAT-4 row on the fp32 form), the lesser of the
two runs printed, and each variant's ptxas report. The variants change the
bf16 builds' settings (a ``constexpr`` function's last ``return``; the fp32
form's own line before it stays). A variant whose change no longer applies
to the source raises. Needs a CUDA card.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "_checkout" / "ablate_ga"
SOURCE = "iseg_tpu_torch/csrc/global_attention.cu"


def _swap(old: str, new: str, count: int = 0):
    def apply(src: str) -> str:
        found = src.count(old)
        if not found or (count and found != count):
            raise ValueError(f"the ablation no longer applies: {old[:60]!r} found {found} times")
        return src.replace(old, new)
    return apply


def _returns(function: str, value: str):
    """The constexpr ``function``'s last ``return`` (its bf16 value, after
    the fp32 form's ``if constexpr`` line) replaced by ``return value;``."""
    def apply(src: str) -> str:
        pattern = rf"(constexpr int {function}\(\) {{\n(?:  if constexpr [^\n]*\n)?  return )[^;]+;"
        out, found = re.subn(pattern, rf"\g<1>{value};", src)
        if found != 1:
            raise ValueError(f"the ablation no longer applies: {function} found {found} times")
        return out
    return apply


VARIANTS = {
    "base": lambda src: src,
    # exp2f in place of the special-function unit's ex2.approx.ftz
    "exp2f": _swap('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;',
                   "  return exp2f(x);"),
    # the forward at D = 64 with 128-key tiles (three blocks an SM), or with
    # two m-tiles a warp (as at D = 32; two blocks an SM)
    "fwd_k128_m1x3": lambda src: _returns("fwd_min_blocks",
                                          "kBias ? (kD <= 64 ? 3 : 1) : (kD == 64 ? 3 : 1)")(
        _returns("fwd_keys", "kBias ? 64 : 128")(src)),
    "fwd_m2": lambda src: _returns("fwd_min_blocks", "kBias ? (kD <= 64 ? 3 : 1) : 1")(
        _returns("fwd_mtiles", "kBias ? 1 : 2")(src)),
    # the reference max moved (and the sums rescaled) whenever a row's max grows
    "fwd_slack0": _swap("constexpr float kRescaleSlack = 8.f;",
                        "constexpr float kRescaleSlack = 0.f;"),
    # a last tile of few keys computed whole
    "fwd_no_half_tail": _swap("if (S - t * kKeys <= kKeys / 2)", "if (false)"),
    # one backward block an SM asked for (up to 255 registers a thread)
    "bwd_x1": _returns("bwd_min_blocks", "1"),
    # the bias form: its forward and dbias kernels at two resident blocks
    # an SM (up to 255 registers a thread), its dk / dv and dq kernels at two
    "bias_fwd_x2": _returns("fwd_min_blocks", "kBias ? (kD <= 64 ? 2 : 1) : (kD == 64 ? 4 : 1)"),
    "bias_dbias_x2": _returns("dbias_min_blocks", "kD <= 64 ? 2 : 1"),
    # the fp32 form: hi by truncation (the operand passed whole: the TF32
    # product reads only its top 19 bits), lo = x - trunc(x): two
    # instructions a split where rounding takes four
    "f32_trunc_split": _swap(
        "    hi[i] = to_tf32(x);\n"
        "    lo[i] = __float_as_uint(x - __uint_as_float(hi[i])) & 0xFFFFE000u;",
        "    hi[i] = __float_as_uint(x);\n"
        "    lo[i] = __float_as_uint(x - __uint_as_float(hi[i] & 0xFFFFE000u));"),
    # the fp32 backward at three blocks an SM (168 registers) at D = 64, or
    # with a whole 64-column sub-step (as bf16)
    "f32_bwd_x3": _swap("  if constexpr (kF32<E>) return kD <= 32 ? 3 : kD <= 64 ? 2 : 1;",
                        "  if constexpr (kF32<E>) return kD <= 64 ? 3 : 1;"),
    "f32_sub_full": _swap("  return (kD <= 64 ? 64 : 32) / (kF32<E> ? 2 : 1);",
                          "  return kD <= 64 ? 64 : 32;"),
    # the fp32 forward at two blocks an SM at D = 64 (up to 255 registers)
    "f32_fwd_x2": _swap("kD <= 64 ? (kBias ? 2 : 3) : 1;", "kD <= 64 ? 2 : 1;"),
}

# (B, H, T, D, with MOAT's relative bias, fp32): phase 2's global rows
ROWS = {
    "ViT-L": (8, 16, 1025, 64, False, False),
    "EVA02-L patch dropout": (4, 16, 769, 64, False, False),
    "MOAT-4 stage 2": (2, 32, 1024, 32, False, False),
    "MOAT-4 stage 2 bias": (2, 32, 1024, 32, True, False),
    "ViT-L f32": (8, 16, 1025, 64, False, True),
    "MOAT-4 stage 2 bias f32": (2, 32, 1024, 32, True, True),
}

CHILD = r'''
import json, math, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
from iseg_tpu_torch.ops.kernels import _build
from iseg_tpu_torch.ops.kernels import global_attention as ga
assert ga.__file__.startswith(sys.argv[1]), ga.__file__
built = _build.load(ga.SOURCE)
if sys.argv[3] == "build":
    print(json.dumps({"build_s": built.seconds, "log": built.log}))
    sys.exit(0)
import chip_smoke as cs
device = torch.device("cuda")
row = {}
for name, (b, heads, t, d, with_bias, f32) in json.loads(sys.argv[4]).items():
    dtype = torch.float32 if f32 else torch.bfloat16
    qh, kh, vh, douth = cs.ga_inputs(device, b, heads, t, d, dtype)
    q, k, v, dout = (x.permute(0, 2, 1, 3) for x in (qh, kh, vh, douth))
    bias = (0.1 * torch.randn((heads, t, t), device=device, generator=torch.Generator(
        device=device).manual_seed(1))) if with_bias else None
    reps = dict(reps=10, warmup=2)
    with torch.no_grad():
        row[name + " fwd"] = cs.device_ms(lambda _: ga.global_attention(q, k, v, bias=bias),
                                          **reps)
        want = ga.global_attention_reference(q, k, v, bias=bias).float()
        err = (ga.global_attention(q, k, v, bias=bias).float() - want).abs().max()
        row[name + " out err"] = float(err) / max(1.0, float(want.abs().max()))

    def setup():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)] + (
            [] if bias is None else [bias.detach().clone().requires_grad_(True)])
        return leaves, ga.global_attention(*leaves[:3], bias=leaves[3] if leaves[3:] else None)

    row[name + " bwd"] = cs.device_ms(lambda arg: torch.autograd.grad(arg[1], arg[0], dout),
                                      setup=setup, **reps)
    del q, k, v, dout, qh, kh, vh, douth, bias
    torch.cuda.empty_cache()
print(json.dumps(row))
'''


def _registers(log: str) -> str:
    """'kernel<D[, bias]>: registers / spill bytes' for each kernel in a ptxas
    report."""
    found = re.findall(r"ga_(\w+?)_kernel(?:I(13__nv_bfloat16|f)(?:Li(\d+)E)?(?:Lb(\d)E)?E)?"
                       r".*?\n.*?(\d+) bytes spill stores.*?\n.*?Used (\d+) registers", log)
    return ", ".join(f"{k}<{'f32' if e == 'f' else 'bf16'}, {d or '-'}"
                     f"{', bias' if b == '1' else ''}> {r}r/{s}sp" for k, e, d, b, s, r in found)


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
        out, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"{n}: build failed\n{err[-3000:]}")
        print(f"{n}: {_registers(json.loads(out.strip().splitlines()[-1])['log'])}", flush=True)
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
    print(f"device ms (and the forward's error, of max(1, max |plain|)), the lesser of two runs "
          f"({card}):")
    for n, rs in runs.items():
        print(f"{n:8s}", "  ".join(f"{k}: {min(r[k] for r in rs):.4g}" for k in rs[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
