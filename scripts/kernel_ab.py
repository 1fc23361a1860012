"""Time kernels of another source tree beside this tree's, in one process
on one CUDA card.

    mkdir -p build/ab_old
    git archive <commit> src/repro_torch/csrc | tar -x -C build/ab_old
    python3 scripts/kernel_ab.py --against build/ab_old [--only b2,b6,b7]

Builds the other tree's sources of the chosen kernels (``--only``, any of
b2, b4, b5, b6, b7, b9, b10, b9bwd, b10bwd, b9f32, b9bwdf32; all by
default) into a library of
their own (the same nvcc flags) and calls both libraries through this
tree's wrappers.  The other tree is this tree's parent: its C entries
must take this tree's arguments, or, for B9, those of d21a112's entries
(before the query offset, the key mask and the mean of v), which are
called without them; any other tree is refused before anything is
built.  Shapes and data:
- B2 ``power_reconstruct_fleet`` at ``chip_smoke.py``'s batch shape (the
  512 packed counters, 8773 columns) as run, wrapping, and padded to a
  width of the other 16-byte alignment (``chip_smoke.b2_cases``); gate:
  power, valid and reordered ``torch.equal`` to the plain version;
- B4 ``xcorr_align`` at ``chip_smoke.py``'s windowed shape (the second
  replay window regridded: 1024 x 2048 against 129 lags padded to 256)
  and batch shape (1024 x ~16k against 1025 lags padded to 1152).
  Each one's largest error against the plain
  version and against the float64 scores, and the rows whose argmax lag
  and whose ``peak_to_delay`` estimate differ from the other tree's;
  gate: this tree's kernel within 1e-5 of both, rows scored alone
  ``torch.equal`` to the same rows within F
  (``chip_smoke.xcorr_slices``);
- B5 ``grid_resample``, hold, at ``chip_smoke.py``'s windowed shape (the
  second replay window, 1024 rows of ~2.3k samples -> 2048 grid points)
  and batch shape (1024 whole-run rows of ~8.8k samples -> 16384), on
  its seeded 512-device data; gate: values and mask ``torch.equal`` to
  the plain version;
- B6 ``phase_integrate`` at the batch shape (512 x 4097) with the six
  real phases padded to 32, with 32 real windows that all cover the run
  (``chip_smoke.overlap_phases``), and on each row's samples shuffled
  with 32 windows inside the run (``chip_smoke.dense_case``: no term can
  be skipped); gate: 1e-5 x max(|E|, 1 J), NaN at the same places, and
  the two libraries' outputs ``torch.equal`` (the integral both B6 and
  B7 include, ``csrc/phase_windows.cuh``, must leave B6's bits alone);
- B7 ``fleet_attribute`` at the counter chunk (512 x 1025) as run,
  wrapping, with 32 covering windows and on shuffled reads, and at a
  4097-column chunk (``chip_smoke.b7_cases``); gate: 1e-5 x max(|E|,
  1 J), NaN at the same places;
- B9 bf16 causal at llama's (1, 24/8, 1000, 128) and the hybrid's
  (1, 64/8, 1000, 128), B10 at (1, 1000, 16384, 16) with dt float32 and
  x bf16, inputs drawn as ``chip_smoke.check_serve_kernels`` draws them;
- b9f32: B9's float32 forward at every float32 shape ``chip_smoke.py``
  times: the serving shapes (llama's, the hybrid's and moonshot's, 1000
  tokens, causal) and every ``chip_smoke.ZOO_ATTENTION`` shape, inputs
  drawn as ``chip_smoke.check_serve_kernels`` draws them; gate: KERNEL_TOL
  (1e-5) of the plain output's largest magnitude.  Against d21a112's
  entries both libraries' outputs must be ``torch.equal``, since the
  kernels without an offset or a mask are unchanged;
- b9bwdf32: B9's float32 backward at every ``TRAIN_ATTENTION`` shape, as
  b9bwd below with chip_smoke's float32 gate (KERNEL_TOL of each
  gradient's largest magnitude, two runs torch.equal);
- b9bwd, b10bwd: the backward kernels, B9's in bf16 at every
  ``chip_smoke.TRAIN_ATTENTION`` shape and B10's at every
  ``SCAN_BWD_SHAPES`` shape, inputs drawn as
  ``chip_smoke.check_attention_backward`` / ``check_scan_backward`` draw
  them; gate: chip_smoke's (the plain gradient, two runs torch.equal;
  against d21a112's entries both libraries' B9 gradients
  ``torch.equal``).
Each kernel is timed with ``chip_smoke.timed`` in the order other, this,
this, other; the ratio of the means is printed with the card's SM clock
before and after.  With b9, the bf16 edge cases of
``tests/test_torch_gpu.py::test_cuda_flash_attention_bf16_tensor_cores_edges``
then run through both libraries, each one's largest error against the
plain version printed as the gate measures it (relative to the plain
output's largest magnitude) and in bf16 ulps at that magnitude.  The last
line is one JSON object; the exit code is 1 if a kernel of this tree
fails its gate.  Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import itertools
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCES = {"b2": "power_reconstruct_fleet.cu", "b4": "xcorr_align.cu",
           "b5": "grid_resample.cu",
           "b6": "phase_integrate.cu", "b7": "fleet_attribute.cu",
           "b9": "flash_attention.cu", "b10": "selective_scan.cu",
           "b9bwd": "flash_attention_bwd.cu",
           "b10bwd": "selective_scan_bwd.cu",
           "b9f32": "flash_attention.cu",
           "b9bwdf32": "flash_attention_bwd.cu"}


def build_other(tree: Path, build, names) -> Path:
    """The other tree's sources ``names`` as one shared library."""
    csrc = tree / "src" / "repro_torch" / "csrc"
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for name in names:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    out = build.BUILD_DIR / f"libab_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    objs = [out.with_name(f"{out.stem}_{Path(n).stem}.o") for n in names]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-Xptxas=-v", "-c",
                               str(csrc / n), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for n, o in zip(names, objs)]
    for n, p in zip(names, procs):
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the other {n}:\n{log}")
        print(f"the other {n}:\n{log}", end="")
    subprocess.run([nvcc, *build.ARCH, "-shared", "-o", str(out),
                    *map(str, objs)], check=True)
    return out


# B9's entries in d21a112, before the query offset, the key mask and
# the mean of v (vsum in the backward): this tree's entries add those
# three arguments before the stream, at FA_EXT_AT
FA_PARENT_ARGS = {"flash_attention.cu": [17],
                  "flash_attention_bwd.cu": [22]}
FA_EXT_AT = {"fa_launch_": 16, "fa_bwd_launch_": 21}


def entry_args(tree: Path, key: str) -> list:
    """The argument counts of the C entries (``extern "C" int f(...)``)
    in ``tree``'s source of ``key``."""
    path = tree / "src" / "repro_torch" / "csrc" / SOURCES[key]
    src = path.read_text() if path.is_file() else ""
    return [m.count(",") + 1
            for m in re.findall(r'extern "C" int \w+\(([^)]*)\)', src)]


@contextlib.contextmanager
def using(lib, build, fa_parent: bool = False):
    """Route the wrappers' C entries to ``lib`` (None: this tree's);
    ``fa_parent``: ``lib``'s B9 entries are d21a112's, called without the
    query offset, the key mask and the mean of v (a call that passes any
    raises)."""
    saved = build.c_function

    def entry(name, argtypes):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        at = next((i for pre, i in FA_EXT_AT.items()
                   if name.startswith(pre)), None)
        if not fa_parent or at is None:
            fn.argtypes = argtypes
            return fn
        keep = [i for i in range(len(argtypes)) if not at <= i < at + 3]
        fn.argtypes = [argtypes[i] for i in keep]

        def call(*a):
            if a[at] or any(x is not None for x in a[at + 1:at + 3]):
                raise ValueError("the other tree's B9 takes no query "
                                 "offset or key mask")
            return fn(*(a[i] for i in keep))
        return call
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


def attribution_calls(cs, seed: int, dev, want) -> dict:
    """B2, B5, B6 and B7 at ``chip_smoke.py``'s shapes, on its seeded data:
    name -> (kernel call, plain call, comparison -> (dict, passed), and
    whether both libraries must give the same bits)."""
    if not {"b2", "b5", "b6", "b7"} & set(want):
        return {}
    import torch
    from repro_torch.fleet import StreamConfig, TrackConfig
    from repro_torch.fleet.pipeline import (_min_cadence, default_tail,
                                            pack_stream_rows)
    from repro_torch.kernels.fleet_attribute import (fleet_attribute_kernel,
                                                     fleet_attribute_ref)
    from repro_torch.kernels.grid_resample import (grid_resample_kernel,
                                                   grid_resample_ref)
    from repro_torch.kernels.phase_integrate import (phase_energies_ref,
                                                     phase_integrate_kernel)
    from repro_torch.kernels.power_reconstruct import (
        power_reconstruct_fleet_kernel)
    from repro_torch.kernels.power_reconstruct.ref import (
        reconstruct_power_fleet_ref)
    truth, groups, delays = cs.sim_groups(cs.DEVICES, cs.SPAN_S, seed)
    phases = cs.phases_of(truth)
    b2, b5_batch, _, b6, b7 = cs.batch_kernel_inputs(groups, truth, phases,
                                                     delays, dev)
    calls = {}

    def close(got, want):
        diff, rel = cs.energy_err(got, want)
        return {"max_abs": diff, "max_rel": rel}, rel <= cs.KERNEL_TOL

    if "b2" in want:
        def same(got, want):
            res = {k: torch.equal(g, w) for k, g, w in
                   zip(("power", "valid", "reordered"), got, want)}
            return res, all(res.values())
        for label, args in cs.b2_cases(*b2):
            f, s = args[0].shape
            calls[f"B2 ({f}x{s}) {label}"] = (
                lambda args=args: power_reconstruct_fleet_kernel(*args),
                lambda args=args: reconstruct_power_fleet_ref(*args), same)
    if "b7" in want:
        for label, args in cs.b7_cases(*b7, cs.b7_wide(b2, b7)):
            r, s = args[0].shape
            calls[f"B7 ({r}x{s}) {label}"] = (
                lambda args=args: fleet_attribute_kernel(*args),
                lambda args=args: fleet_attribute_ref(*args), close)

    def regrid(b5):
        t, v, n, first, grid, d = b5

        def same(got, want):
            res = {"mask_equal": torch.equal(got[1], want[1]),
                   "hold_equal": torch.equal(got[0], want[0])}
            return res, all(res.values())
        return (lambda: grid_resample_kernel(t, v, n, first, grid, d),
                lambda: grid_resample_ref(t, v, n[:, None], first[:, None],
                                          grid[:, None], d[:, None],
                                          sorted_search=True), same)
    if "b5" in want:
        rows = pack_stream_rows([tr for g in groups for tr in g])
        chunk = StreamConfig().chunk
        step = 0.5 * _min_cadence(rows)
        tail = default_tail(rows, chunk, max_lag=TrackConfig().max_lag,
                            grid_step=step)
        _, b5_win, _, _ = cs.kernel_inputs(rows, delays, truth, tail, chunk,
                                           step, dev)
        for label, b5 in (("windowed", b5_win), ("batch", b5_batch)):
            f, s = b5[0].shape
            calls[f"B5 {label} ({f}x{s} -> {b5[4].shape[0]}) hold"] = \
                regrid(b5)
    if "b6" in want:
        t, w, ph = b6
        r, s = t.shape
        for label, args in (
                ("6 real phases padded to 32", (t, w, ph)),
                ("32 overlapping windows", (t, w, cs.overlap_phases(t))),
                ("shuffled samples, 32 interior windows",
                 cs.dense_case(t, w))):
            # the shared header must leave B6 as it was: same bits
            calls[f"B6 ({r}x{s}) {label}"] = (
                lambda args=args: phase_integrate_kernel(*args),
                lambda args=args: phase_energies_ref(*args), close, True)
    return calls


def serve_calls(cs, gen, dev, want, same_bits: bool = False) -> dict:
    """B9 and B10 at the serve path's shapes, as
    ``chip_smoke.check_serve_kernels`` draws their inputs; with
    ``same_bits`` B9's two libraries must give the same bits (the other
    tree is this one's parent: kernels this tree did not change)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_ref)
    from repro_torch.kernels.ssm_scan import (selective_scan_kernel,
                                              selective_scan_ref)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def rel(got, want):
        r = cs._rel_err(got, want)
        return {"rel": r}, r <= cs.BF16_TOL

    def scan(got, want):
        res = {"y_rel": cs._rel_err(got[0], want[0]),
               "h_last_equal": torch.equal(got[1], want[1])}
        return res, res["y_rel"] <= cs.BF16_TOL and res["h_last_equal"]

    def rel_f32(got, want):
        r = cs._rel_err(got, want)
        return {"rel": r}, r <= cs.KERNEL_TOL

    bf16 = torch.bfloat16
    calls = {}
    same = (True,) if same_bits else ()
    if "b9f32" in want:
        for label, hq, hkv in (("llama", 24, 8), ("hybrid", 64, 8),
                               ("moonshot", 16, 16)):
            q = randn(1, hq, 1000, 128, scale=3.0)
            k = randn(1, hkv, 1000, 128, scale=3.0)
            v = randn(1, hkv, 1000, 128)
            calls[f"B9 {label} (1,{hq}/{hkv},1000,128) float32 causal"] = (
                lambda q=q, k=k, v=v: flash_attention_kernel(q, k, v),
                lambda q=q, k=k, v=v: flash_attention_ref(q, k, v), rel_f32,
                *same)
        for label, hq, hkv, sq, sk, d, causal, window, cap in \
                cs.ZOO_ATTENTION:
            q = randn(1, hq, sq, d, scale=3.0)
            k = randn(1, hkv, sk, d, scale=3.0)
            v = randn(1, hkv, sk, d)
            opts = dict(causal=causal, logit_cap=cap, window=window)
            calls[f"B9 {label} (1,{hq}/{hkv},{sq}->{sk},{d}) float32 "
                  f"causal={causal} window={window} cap={cap:g}"] = (
                lambda q=q, k=k, v=v, o=opts: flash_attention_kernel(
                    q, k, v, **o),
                lambda q=q, k=k, v=v, o=opts: flash_attention_ref(
                    q, k, v, **o), rel_f32, *same)
    if "b9" in want:
        for label, hq in (("llama", 24), ("hybrid", 64)):
            q = randn(1, hq, 1000, 128, scale=3.0).to(bf16)
            k = randn(1, 8, 1000, 128, scale=3.0).to(bf16)
            v = randn(1, 8, 1000, 128).to(bf16)
            calls[f"B9 {label} (1,{hq}/8,1000,128) bf16 causal"] = (
                lambda q=q, k=k, v=v: flash_attention_kernel(q, k, v),
                lambda q=q, k=k, v=v: flash_attention_ref(q, k, v), rel,
                *same)
    if "b10" in want:
        dt = torch.nn.functional.softplus(randn(1, 1000, 16384) - 1.0)
        x = randn(1, 1000, 16384).to(bf16)
        bm, cm = randn(1, 1000, 16), randn(1, 1000, 16)
        a = -torch.exp(randn(16384, 16, scale=0.5))
        h0 = randn(1, 16384, 16)
        calls["B10 (1,1000,16384,16) dt f32, x bf16"] = (
            lambda: selective_scan_kernel(dt, x, bm, cm, a, h0),
            lambda: selective_scan_ref(dt, x, bm, cm, a, h0), scan)
    return calls


def flash_edges(cs, other, build, dev, fa_parent=False) -> dict:
    """B9 bf16's worst error over the card tests' edge cases, both
    libraries."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_ref)
    from torch_cases import _attention_case
    bf16 = torch.bfloat16
    worst = {"other": (0.0, None), "this": (0.0, None)}
    for s, d, group, causal, cap in itertools.product(
            (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000), (64, 128),
            (1, 3, 8), (True, False), (0.0, 30.0)):
        q, k, v = (torch.from_numpy(t).to(dev, bf16) for t in
                   _attention_case(3, b=1, hq=2 * group, hkv=2, s=s, d=d))
        want = flash_attention_ref(q, k, v, causal=causal, logit_cap=cap)
        for side, lib in (("other", other), ("this", None)):
            with using(lib, build, fa_parent and lib is not None):
                got = flash_attention_kernel(q, k, v, causal=causal,
                                             logit_cap=cap)
            rel = cs._rel_err(got, want)
            if rel >= worst[side][0]:
                ulps = ((got.float() - want.float()).abs().max().item()
                        / top_ulp(want))
                worst[side] = (rel, dict(s=s, d=d, hq=2 * group, hkv=2,
                                         causal=causal, cap=cap,
                                         top_ulps=ulps))
    edges = {}
    for side, (rel, case) in worst.items():
        edges[side] = dict(max_rel_err=rel, case=case)
        print(f"B9 bf16 edge cases, {side}: worst {rel:.4e} (gate "
              f"{cs.BF16_TOL:g}) at {case}")
    return edges


def backward_ab(cs, other, want, seed: int, dev,
                fa_parent: bool = False) -> tuple:
    """B9's backward (bf16 for b9bwd, float32 for b9bwdf32) at every
    ``chip_smoke.TRAIN_ATTENTION`` shape and B10's at every
    ``chip_smoke.SCAN_BWD_SHAPES`` shape, inputs drawn as chip_smoke draws
    them, the other tree's kernel beside this tree's: each held to
    chip_smoke's gates against the plain gradient (B9 bf16 BF16_BWD_TOL,
    float32 KERNEL_TOL; B10 float32 KERNEL_TOL, bf16 SCAN_BWD_BF16_TOL)
    and to two runs torch.equal (with ``fa_parent``, B9's two libraries
    to each other too), then timed other, this, this, other -> (result,
    failed names)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_ref)
    from repro_torch.kernels.flash_attention.kernel import _forward
    from repro_torch.kernels.ssm_scan import (selective_scan_bwd_kernel,
                                              selective_scan_ref)
    from repro_torch.kernels.ssm_scan.kernel import _forward as scan_forward
    randn = cs.seeded_randn(dev, seed)
    result, failed = {}, []

    def run(name, sides, gate, equal=False):
        """sides: {"other": fn, "this": fn} -> the gates, then timings;
        ``equal``: the two sides' gradients must be the same bits."""
        checks, ok, outs = {}, True, {}
        for side, fn in sides.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            checks[side] = dict(gate(got), two_runs_equal=all(
                torch.equal(g, r) for g, r in zip(got, again)))
            if side == "this" and not (checks[side]["passed"]
                                       and checks[side]["two_runs_equal"]):
                ok = False
            if equal:
                outs[side] = got
            del got, again
        if equal:
            checks["libraries_equal"] = all(
                torch.equal(a, b) for a, b in zip(outs["other"],
                                                  outs["this"]))
            ok = ok and checks["libraries_equal"]
            del outs
        if not ok:
            failed.append(name)
        before = cs.gpu_clocks()
        ms = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            ms[side].append(cs.timed(sides[side], reps=10)["device_ms"])
        after = cs.gpu_clocks()
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        result[name] = dict(ms=ms, ratio=mean["other"] / mean["this"],
                            checks=checks, clocks_before=before,
                            clocks_after=after)
        print(f"{name}: other {ms['other']} ms, this {ms['this']} ms, "
              f"other/this {mean['other'] / mean['this']:.3f}; {checks}; "
              f"card before {before}, after {after}", flush=True)

    bf16 = torch.bfloat16
    for key, dtype, tol in (("b9bwd", bf16, cs.BF16_BWD_TOL),
                            ("b9bwdf32", torch.float32, cs.KERNEL_TOL)):
        if key not in want:
            continue
        # the padded heads (PADDED_TRAIN) are this tree's wrapper, not a
        # C entry the other tree has
        for (label, b, hq, hkv, sq, sk, d, causal, window,
             cap) in (c for c in cs.TRAIN_ATTENTION
                      if c[0] not in cs.PADDED_TRAIN):
            q = randn(b, hq, sq, d, scale=3.0).to(dtype)
            k = randn(b, hkv, sk, d, scale=3.0).to(dtype)
            v = randn(b, hkv, sk, d).to(dtype)
            do = randn(b, hq, sq, d).to(dtype)
            opts = dict(causal=causal, logit_cap=cap, window=window)
            with torch.no_grad():
                out, lse = _forward(q, k, v, causal, cap, window, True)
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            want_g = torch.autograd.grad(
                flash_attention_ref(qg, kg, vg, **opts), (qg, kg, vg), do)

            def gate(got, want_g=want_g, tol=tol):
                rels = [cs._rel_err(g, w) for g, w in zip(got, want_g)]
                return {"rel_dq_dk_dv": rels, "passed": max(rels) <= tol}

            def this(q=q, k=k, v=v, out=out, do=do, lse=lse, opts=opts):
                return flash_attention_bwd_kernel(q, k, v, out, do, lse,
                                                  **opts)

            def theirs(q=q, k=k, v=v, out=out, do=do, lse=lse, opts=opts):
                with using(other, build, fa_parent):
                    return flash_attention_bwd_kernel(q, k, v, out, do, lse,
                                                      **opts)
            run(f"B9 backward {label} ({b},{hq}/{hkv},{sq}->{sk},{d}) "
                f"{str(dtype)[6:]} causal={causal} window={window} "
                f"cap={cap:g}", {"other": theirs, "this": this}, gate,
                equal=fa_parent)
            del q, k, v, do, out, lse, qg, kg, vg, want_g
            torch.cuda.empty_cache()
    if "b10bwd" in want:
        for label, b, seq, d, n, dtn, xn, given in cs.SCAN_BWD_SHAPES:
            dtd, xd = getattr(torch, dtn), getattr(torch, xn)
            dt = F.softplus(randn(b, seq, d) - 1.0).to(dtd)
            x = randn(b, seq, d).to(xd)
            bm, cm = randn(b, seq, n), randn(b, seq, n)
            a = -torch.exp(randn(d, n, scale=0.5))
            h0 = (randn(b, d, n) if given
                  else torch.zeros((b, d, n), device=dev))
            dy = randn(b, seq, d).to(xd)
            dh = randn(b, d, n) if given else None
            with torch.no_grad():
                _, _, h_chunk = scan_forward(dt, x, bm, cm, a, h0, True)
            ins = [t.clone().requires_grad_()
                   for t in (dt, x, bm, cm, a, h0)]
            y, h = selective_scan_ref(*ins)
            want_g = torch.autograd.grad((y, h) if given else (y,), ins,
                                         (dy, dh) if given else (dy,))
            del ins, y, h

            def gate(got, want_g=want_g):
                rels = {k: cs._rel_err(g, w)
                        for k, g, w in zip(cs.SCAN_GRADS, got, want_g)}
                passed = all(
                    r <= (cs.KERNEL_TOL if g.dtype == torch.float32
                          else cs.SCAN_BWD_BF16_TOL)
                    for r, g in zip(rels.values(), got))
                return {"rel": rels, "passed": passed}
            args = (dt, x, bm, cm, a, h_chunk, dy, dh)

            def this(args=args):
                return selective_scan_bwd_kernel(*args)

            def theirs(args=args):
                with using(other, build):
                    return selective_scan_bwd_kernel(*args)
            run(f"B10 backward {label} ({b},{seq},{d},{n}) dt {dtn} x {xn}"
                + (" with dh_last" if given else ""),
                {"other": theirs, "this": this}, gate)
            del dt, x, bm, cm, a, h0, dy, dh, h_chunk, want_g, args
            torch.cuda.empty_cache()
    return result, failed


def xcorr_ab(cs, other, seed: int, dev) -> tuple:
    """B4 at ``chip_smoke.py``'s two shapes, the other tree's kernel
    beside this tree's -> (result, failed names)."""
    import torch
    from repro_torch.align.delay import peak_to_delay
    from repro_torch.fleet import StreamConfig, TrackConfig
    from repro_torch.fleet.pipeline import (_min_cadence, default_tail,
                                            pack_stream_rows)
    from repro_torch.kernels import build
    from repro_torch.kernels.grid_resample import grid_resample_kernel
    from repro_torch.kernels.xcorr_align import (xcorr_align_kernel,
                                                 xcorr_scores_ref)
    truth, groups, delays = cs.sim_groups(cs.DEVICES, cs.SPAN_S, seed)
    rows = pack_stream_rows([tr for g in groups for tr in g])
    chunk = StreamConfig().chunk
    step = 0.5 * _min_cadence(rows)
    tail = default_tail(rows, chunk, max_lag=TrackConfig().max_lag,
                        grid_step=step)
    _, b5, (bank_w, lags_w), _ = cs.kernel_inputs(rows, delays, truth, tail,
                                                  chunk, step, dev)
    x_w, m_w = grid_resample_kernel(*b5)
    _, _, b4, _, _ = cs.batch_kernel_inputs(
        groups, truth, cs.phases_of(truth), delays, dev)
    shapes = {"windowed": (x_w, m_w.to(torch.float32), bank_w, lags_w),
              "batch": b4}

    def run_other(x, m, b, n):
        with using(other, build):
            return xcorr_align_kernel(x, m, b, n_lags=n)

    sides = {"other": run_other,
             "this": lambda x, m, b, n: xcorr_align_kernel(x, m, b,
                                                           n_lags=n)}
    result, failed = {}, []
    for label, (x, m, bank, lags) in shapes.items():
        plain = xcorr_scores_ref(x, m, bank)
        exact = xcorr_scores_ref(x.double(), m.double(), bank.double())
        max_lag = (lags - 1) // 2
        outs = {k: fn(x, m, bank, lags) for k, fn in sides.items()}
        torch.cuda.synchronize()
        est = {k: peak_to_delay(o[:, :lags], 1.0, max_lag)
               for k, o in outs.items()}
        checks = {k: {"vs_plain": (o - plain).abs().max().item(),
                      "vs_float64": (o.double() - exact).abs().max().item()}
                  for k, o in outs.items()}
        checks["argmax_rows_changed"] = int(
            (outs["this"][:, :lags].argmax(1)
             != outs["other"][:, :lags].argmax(1)).sum())
        checks["delay_rows_changed"] = int(
            (est["this"].lag_steps != est["other"].lag_steps).sum())
        checks["delay_worst_change_steps"] = (
            est["this"].lag_steps - est["other"].lag_steps).abs().max(
            ).item()
        checks["plain_vs_float64"] = (plain.double() - exact).abs().max(
            ).item()
        alone = {f"[{a}:{b}]": torch.equal(xcorr_align_kernel(
            x[a:b].contiguous(), m[a:b].contiguous(), bank, n_lags=lags),
            outs["this"][a:b]) for a, b in cs.xcorr_slices(x.shape[0])}
        checks["rows_alone_equal"] = alone
        del plain, exact, outs
        name = f"B4 {label} ({x.shape[0]}x{x.shape[1]} x {lags} lags)"
        if not (checks["this"]["vs_plain"] <= cs.KERNEL_TOL
                and checks["this"]["vs_float64"] <= cs.KERNEL_TOL
                and all(alone.values())):
            failed.append(name)
        before = cs.gpu_clocks()
        ms = {k: [] for k in sides}
        for k in ("other", "this", "this", "other"):
            ms[k].append(cs.timed(lambda k=k: sides[k](x, m, bank, lags),
                                  reps=10)["device_ms"])
        after = cs.gpu_clocks()
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        result[name] = dict(ms=ms, ratio=mean["other"] / mean["this"],
                            checks=checks, clocks_before=before,
                            clocks_after=after)
        print(f"{name}: other {ms['other']} ms, this {ms['this']} ms, "
              f"other/this {result[name]['ratio']:.3f}; {checks}; card "
              f"before {before}, after {after}")
    return result, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="a tree holding src/repro_torch/csrc")
    ap.add_argument("--only", default=",".join(SOURCES),
                    help=f"kernels to compare: any of "
                         f"{', '.join(SOURCES)}")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    want = [k.strip() for k in args.only.split(",") if k.strip()]
    if not want or set(want) - set(SOURCES):
        ap.error(f"--only takes a list of {', '.join(SOURCES)}")
    fa_parent = False
    for key in want:
        theirs, mine = (entry_args(t, key) for t in (args.against, ROOT))
        if theirs == FA_PARENT_ARGS.get(SOURCES[key]):
            fa_parent = True
        elif theirs != mine:
            ap.error(f"{key}: the other tree's C entries take {theirs} "
                     f"arguments, this tree's {mine}: compare this tree "
                     f"with its parent")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"this tree's kernels built in "
          f"{build.timed_build(verbose=True):.1f} s")
    other = ctypes.CDLL(str(build_other(
        args.against, build, list(dict.fromkeys(SOURCES[k] for k in want)))))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    calls = {**attribution_calls(cs, args.seed, dev, want),
             **serve_calls(cs, gen, dev, want, same_bits=fa_parent)}

    result = {"timing": {}, "edges": {}}
    failed = []
    if "b4" in want:
        result["xcorr"], failed = xcorr_ab(cs, other, args.seed, dev)
    if {"b9bwd", "b9bwdf32", "b10bwd"} & set(want):
        result["backward"], bwd_failed = backward_ab(
            cs, other, want, args.seed, dev, fa_parent=fa_parent)
        failed += bwd_failed
    for name, (fn, ref, compare, *same_bits) in calls.items():
        want_out = ref()
        checks, outs = {}, {}
        for side, lib in (("other", other), ("this", None)):
            with using(lib, build, fa_parent and lib is not None):
                outs[side] = fn()
                checks[side], ok = compare(outs[side], want_out)
            if not ok and side == "this":
                failed.append(name)
        if same_bits:
            checks["libraries_equal"] = torch.equal(outs["other"],
                                                    outs["this"])
            if not checks["libraries_equal"]:
                failed.append(f"{name}: the two libraries differ")
        del want_out, outs
        before = cs.gpu_clocks()
        ms = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            with using(other if side == "other" else None, build,
                       fa_parent and side == "other"):
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
    if "b9" in want:
        result["edges"] = flash_edges(cs, other, build, dev, fa_parent)
    result["failed"] = failed
    print(json.dumps(result, default=str))
    if failed:
        print(f"kernel_ab: this tree fails its gate on {failed}",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
