"""Time B9 and B10 of another source tree beside this tree's, in one
process on one CUDA card.

    mkdir -p build/ab_old
    git archive <commit> src/repro_torch/csrc | tar -x -C build/ab_old
    python3 scripts/kernel_ab.py --against build/ab_old

Builds the other tree's ``flash_attention.cu`` and ``selective_scan.cu``
into a library of their own (the same nvcc flags) and calls both
libraries through this tree's wrappers (the C entries take the same
arguments).  At the serve path's shapes -- B9 bf16 causal at llama's
(1, 24/8, 1000, 128) and the hybrid's (1, 64/8, 1000, 128), B10 at
(1, 1000, 16384, 16) with dt float32 and x bf16, inputs drawn as
``chip_smoke.check_serve_kernels`` draws them -- it times each kernel
with ``chip_smoke.timed`` in the order other, this, this, other and
prints the ratio of the means, with the card's SM clock before and
after.  Then it runs the bf16 edge cases of
``tests/test_torch_gpu.py::test_cuda_flash_attention_bf16_tensor_cores_edges``
through both libraries and prints each one's largest error against the
plain version, as the gate measures it (relative to the plain output's
largest magnitude) and in bf16 ulps at that magnitude.  The last line
is one JSON object.  Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("flash_attention.cu", "selective_scan.cu")


def build_other(tree: Path, build) -> Path:
    """The other tree's B9 and B10 sources as one shared library."""
    csrc = tree / "src" / "repro_torch" / "csrc"
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((csrc / name).read_bytes())
    out = build.BUILD_DIR / f"libab_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    objs = [out.with_name(f"{out.stem}_{Path(n).stem}.o") for n in SOURCES]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c",
                               str(csrc / n), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for n, o in zip(SOURCES, objs)]
    for n, p in zip(SOURCES, procs):
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the other {n}:\n{log}")
    subprocess.run([nvcc, *build.ARCH, "-shared", "-o", str(out),
                    *map(str, objs)], check=True)
    return out


@contextlib.contextmanager
def using(lib, build):
    """Route the wrappers' C entries to ``lib`` (None: this tree's)."""
    saved = build.c_function

    def entry(name, argtypes):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn
    if lib is not None:
        build.c_function = entry
    try:
        yield
    finally:
        build.c_function = saved


def top_ulp(want) -> float:
    """A bf16 ulp at the plain output's largest magnitude."""
    top = want.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="a tree holding src/repro_torch/csrc")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_ref)
    from repro_torch.kernels.ssm_scan import (selective_scan_kernel,
                                              selective_scan_ref)
    from torch_cases import _attention_case
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"this tree's kernels built in "
          f"{build.timed_build(verbose=True):.1f} s")
    other = ctypes.CDLL(str(build_other(args.against, build)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    bf16 = torch.bfloat16
    calls = {}
    for label, hq in (("llama", 24), ("hybrid", 64)):
        q = randn(1, hq, 1000, 128, scale=3.0).to(bf16)
        k = randn(1, 8, 1000, 128, scale=3.0).to(bf16)
        v = randn(1, 8, 1000, 128).to(bf16)
        calls[f"B9 {label} (1,{hq}/8,1000,128) bf16 causal"] = (
            lambda q=q, k=k, v=v: flash_attention_kernel(q, k, v),
            lambda q=q, k=k, v=v: flash_attention_ref(q, k, v))
    dt = torch.nn.functional.softplus(randn(1, 1000, 16384) - 1.0)
    x = randn(1, 1000, 16384).to(bf16)
    bm, cm = randn(1, 1000, 16), randn(1, 1000, 16)
    a = -torch.exp(randn(16384, 16, scale=0.5))
    h0 = randn(1, 16384, 16)
    calls["B10 (1,1000,16384,16) dt f32, x bf16"] = (
        lambda: selective_scan_kernel(dt, x, bm, cm, a, h0),
        lambda: selective_scan_ref(dt, x, bm, cm, a, h0))

    result = {"timing": {}, "edges": {}}
    for name, (fn, ref) in calls.items():
        want = ref()
        checks = {}
        for side, lib in (("other", other), ("this", None)):
            with using(lib, build):
                got = fn()
            if isinstance(got, tuple):          # B10: (y, h_last)
                checks[side] = {"y_rel": cs._rel_err(got[0], want[0]),
                                "h_last_equal": torch.equal(got[1],
                                                            want[1])}
            else:
                checks[side] = {"rel": cs._rel_err(got, want)}
        del want
        before = cs.gpu_clocks()
        ms = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            with using(other if side == "other" else None, build):
                ms[side].append(cs.timed(fn)["device_ms"])
        after = cs.gpu_clocks()
        mean = {s: sum(v) / len(v) for s, v in ms.items()}
        result["timing"][name] = dict(ms=ms, ratio=mean["other"]
                                      / mean["this"], checks=checks,
                                      clocks_before=before,
                                      clocks_after=after)
        print(f"{name}: other {ms['other']} ms, this {ms['this']} ms, "
              f"other/this {mean['other'] / mean['this']:.3f}; {checks}; "
              f"card before {before}, after {after}")

    worst = {"other": (0.0, None), "this": (0.0, None)}
    for s, d, group, causal, cap in itertools.product(
            (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000), (64, 128),
            (1, 3, 8), (True, False), (0.0, 30.0)):
        q, k, v = (torch.from_numpy(t).to(dev, bf16) for t in
                   _attention_case(3, b=1, hq=2 * group, hkv=2, s=s, d=d))
        want = flash_attention_ref(q, k, v, causal=causal, logit_cap=cap)
        for side, lib in (("other", other), ("this", None)):
            with using(lib, build):
                got = flash_attention_kernel(q, k, v, causal=causal,
                                             logit_cap=cap)
            rel = cs._rel_err(got, want)
            if rel >= worst[side][0]:
                ulps = ((got.float() - want.float()).abs().max().item()
                        / top_ulp(want))
                worst[side] = (rel, dict(s=s, d=d, hq=2 * group, hkv=2,
                                         causal=causal, cap=cap,
                                         top_ulps=ulps))
    for side, (rel, case) in worst.items():
        result["edges"][side] = dict(max_rel_err=rel, case=case)
        print(f"B9 bf16 edge cases, {side}: worst {rel:.4e} (gate "
              f"{cs.BF16_TOL:g}) at {case}")
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
