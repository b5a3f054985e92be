#!/usr/bin/env python3
"""Time K18's designs and variants on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_triplane_bench.py [--phase]``. It builds the
kernel library, the first design (``csrc/baselines/triplane_v1.cu``) and edited copies of
``csrc/triplane.cu`` (``VARIANTS``: other block counts and LOD loops, each into a
library of its own; an edit that no longer matches fails the run), prints the ptxas lines of
the K18 kernels (registers, spills), then, at the planes of
``nerf_triplanar_lego_proxy.yaml`` (4 LODs from 2^5, F = 4, 'sum', seeded std 0.1) and on
seeded batches in both sample orders (``chip_smoke.triplane_coords``: a training batch of
512 random rays and a render chunk of 16,384 neighbouring pixels, 512 steps each, flattened
step-major as the tracer's compaction orders them), holds each design and variant
to the plain version (the forward bit for bit, the backward within 1e-5 of the largest
entry of ``chip_smoke.triplane_bwd_f64``, which sums float32 terms in float64) and times it
with ``chip_smoke.timed`` (device ms under torch.profiler, CUDA-event ms beside): the
backward with and without its shared LODs (``chip_smoke.triplane_bwd_options``), the first
design and the library yardstick (``chip_smoke.triplane_library``).
It also prints each backward's error against that reference, the plain version's
included. One JSON line a case, then the card's name and power limit. ``--phase`` first
runs chip_smoke.py's triplanar phase and its "K18 beside its first design" step (the
recorded calls of a real step and frame chunk) and times the variants there.

It fails without a card. Nothing in the package calls it.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys

# name -> edits of csrc/triplane.cu (old, new), each of which must match once
VARIANTS = {
    "fwd 8 blocks an SM": [("constexpr int kFwdMinBlocks = 6;",
                            "constexpr int kFwdMinBlocks = 8;")],
    "fwd LODs in a runtime loop": [("    return n_lods == 4 ? launch_fwd<4, 4>(",
                                    "    return n_lods == 4 ? launch_fwd<4, 0>(")],
    "fwd fmodf on every coordinate": [("  if (!(a >= 0.0f && a < period)) {",
                                       "  if (a == a) {")],
    "bwd without the warp combine": [("  if (!combine_row<V>(row, active, v, lane)) return;",
                                      "  if (!active) return;")],
    "bwd no adds": [("  if (!combine_row<V>(row, active, v, lane)) return;",
                     "  if (!combine_row<V>(row, active, v, lane) || F > 0) return;")],
    "bwd 256 threads": [("constexpr int kBwdThreads = 512;",
                         "constexpr int kBwdThreads = 256;")],
}


def start_variant_builds() -> dict:
    """nvcc on an edited copy of csrc/triplane.cu a variant, all started together."""
    from wisp_tpu_torch import kernels
    src = (kernels.CSRC / "triplane.cu").read_text()
    started = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"chip_triplane_bench: variant {name!r}: {old!r} does not "
                                 f"match once")
            text = text.replace(old, new)
        out = kernels.BUILD_ROOT / "bench" / name.replace(" ", "_").replace(",", "")
        out.mkdir(parents=True, exist_ok=True)
        (out / "triplane.cu").write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
               str(kernels.CSRC), str(out / "triplane.cu"), "-o", str(out / "lib.so")]
        started[name] = (out / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return started


def finish_variant_builds(started) -> dict:
    libs = {}
    for name, (path, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_triplane_bench: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wisp_triplane_fwd.argtypes = [P, L, I, I, I, P, I, I, P, P]
        lib.wisp_triplane_bwd.argtypes = [P, L, I, I, I, P, I, I, P, I, P]
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        libs[name] = lib
    return libs


def stream() -> int:
    import torch
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def fwd_with(lib, coords, flat, out_lods):
    """``triplane._sample_fwd`` ('sum', F % 4 == 0) through a variant's library."""
    import torch
    from wisp_tpu_torch.ops import triplane
    block = triplane._plane_block(flat, flat[0].shape[2])
    out = torch.empty((coords.shape[0], 3 * flat[0].shape[2]), device=coords.device)
    status = lib.wisp_triplane_fwd(coords.data_ptr(), coords.shape[0], len(flat) // 3,
                                   out_lods, flat[0].shape[2], ctypes.addressof(block), 1, 4,
                                   out.data_ptr(), stream())
    if status != 0:
        raise SystemExit(f"variant forward failed to launch ({status})")
    return out


def bwd_with(lib, coords, shapes, grad_out, n_shared):
    """``triplane.triplane_sample_bwd`` ('sum', F % 4 == 0) through a variant's library."""
    import torch
    from wisp_tpu_torch.ops import triplane
    sizes = [a * b * c for a, b, c in shapes]
    flat = torch.zeros((sum(sizes),), dtype=torch.float32, device=coords.device)
    grads = [t.view(sz) for t, sz in zip(torch.split(flat, sizes), shapes)]
    block = triplane._plane_block(grads, shapes[0][2])
    status = lib.wisp_triplane_bwd(coords.data_ptr(), coords.shape[0], len(shapes) // 3,
                                   len(shapes) // 3, shapes[0][2], ctypes.addressof(block), 1,
                                   4, grad_out.data_ptr(), n_shared, stream())
    if status != 0:
        raise SystemExit(f"variant backward failed to launch ({status})")
    return grads


def synthetic_cases(dev, libs):
    import torch
    import chip_smoke as cs
    from wisp_tpu_torch.ops import triplane
    g = torch.Generator().manual_seed(5)
    planes = [tuple((torch.randn(2 ** l + 1, 2 ** l + 1, 4, generator=g) * 0.1).to(dev)
                    for _ in range(3)) for l in range(5, 9)]
    flat = [p for lod in planes for p in lod]
    shapes = [tuple(p.shape) for p in flat]
    permuted = cs.triplane_library_planes(flat)
    partial = functools.partial
    for order, rays in (("train", 512), ("render", 16384)):
        coords = cs.triplane_coords(order, rays, 512, dev, seed=7)
        n = coords.shape[0]
        with torch.no_grad():
            want = triplane.triplane_sample_plain(coords, planes, "sum", 4)
            rec = {"order": order, "samples": n, "pass": "forward"}
            cs.require(torch.equal(triplane._sample_fwd(coords, flat, "sum", 4), want),
                       f"{order}: the forward differs")
            rec["new"] = cs.timed(partial(triplane._sample_fwd, coords, flat, "sum", 4))
            for name, lib in libs.items():
                if name.startswith("fwd"):
                    cs.require(torch.equal(fwd_with(lib, coords, flat, 4), want),
                               f"{order}: variant {name} differs")
                    rec[name] = cs.timed(partial(fwd_with, lib, coords, flat, 4))
            cs.require(torch.equal(cs.TRIPLANE_V1.sample(coords, flat, "sum", 4), want),
                       f"{order}: the first design's forward differs")
            rec["first design"] = cs.timed(partial(cs.TRIPLANE_V1.sample, coords, flat,
                                                   "sum", 4))
            rec["library"] = cs.timed(partial(cs.triplane_library, coords, permuted))
            work = cs.triplane_fwd_work(coords, planes, "sum", 4)
            rec["bound"] = cs.bound(work["bytes"], work["ops"])
            print(json.dumps({"k18_bench": rec}), flush=True)
            del want
            cot = torch.randn((n, 12), generator=torch.Generator(device=dev).manual_seed(9),
                              device=dev) * 1e-3
            ref = cs.triplane_bwd_f64(coords, shapes, "sum", cot)
            scale = max(float(w.abs().max()) for w in ref)
            rec = {"order": order, "samples": n, "pass": "backward", "tol": 1e-5 * scale}

            def err(got):
                return max(float((a.double() - b).abs().max()) for a, b in zip(got, ref))

            rec["plain max_abs_err"] = err(triplane.triplane_sample_bwd_plain(
                coords, shapes, "sum", cot))
            for name, shared in cs.triplane_bwd_options(n, [2 ** l + 1 for l in range(5, 9)],
                                                        4).items():
                e = err(triplane.triplane_sample_bwd(coords, shapes, "sum", cot, shared))
                call = partial(triplane.triplane_sample_bwd, coords, shapes, "sum", cot, shared)
                rec[name] = list(cs.timed(call, iters=10)) + [e]
                rec[f"{name}: device ms by kernel"] = cs.device_ms_by_kernel(call, iters=10)
            for name, lib in libs.items():
                if name.startswith("bwd"):
                    for shared in (0, 2):
                        rec[f"{name}, {shared} shared LODs"] = cs.timed(partial(
                            bwd_with, lib, coords, shapes, cot, shared), iters=10)
            rec["rule"] = triplane.bwd_shared_lods(n, [2 ** l + 1 for l in range(5, 9)], 4)
            rec["first design"] = list(cs.timed(partial(cs.TRIPLANE_V1.sample_bwd, coords,
                                                        shapes, "sum", cot), iters=10)) + [
                err(cs.TRIPLANE_V1.sample_bwd(coords, shapes, "sum", cot))]
            lib_planes = cs.triplane_library_planes(flat, requires_grad=True)
            with torch.enable_grad():
                out = cs.triplane_library(coords, lib_planes)
                rec["library"] = cs.timed(lambda: torch.autograd.grad(
                    out, lib_planes, cot, retain_graph=True), iters=10)
            del out, ref
            print(json.dumps({"k18_bench": rec}), flush=True)
        torch.cuda.empty_cache()


def recorded_calls(libs):
    """The variants at the triplanar phase's recorded calls (step 25's forward and
    backward, the frame chunk's forward)."""
    import torch
    import chip_smoke as cs
    from wisp_tpu_torch.ops import triplane
    partial = functools.partial
    with torch.no_grad():
        for key in ("triplane_fwd", "triplane_fwd_frame"):
            coords, flat, multiscale, out_lods = cs.NEW_GRID_CALLS["triplanar", key]
            want = triplane._sample_fwd(coords, flat, multiscale, out_lods)
            rec = {"call": key, "samples": coords.shape[0],
                   "new": cs.timed(partial(triplane._sample_fwd, coords, flat, multiscale,
                                           out_lods)),
                   "first design": cs.timed(partial(cs.TRIPLANE_V1.sample, coords, flat,
                                                    multiscale, out_lods))}
            for name, lib in libs.items():
                if name.startswith("fwd"):
                    cs.require(torch.equal(fwd_with(lib, coords, flat, out_lods), want),
                               f"{key}: variant {name} differs")
                    rec[name] = cs.timed(partial(fwd_with, lib, coords, flat, out_lods))
            print(json.dumps({"k18_recorded": rec}), flush=True)
        coords, shapes, multiscale, grad_out = cs.NEW_GRID_CALLS["triplanar", "triplane_bwd"]
        rec = {"call": "triplane_bwd", "samples": coords.shape[0],
               "new": cs.timed(partial(triplane.triplane_sample_bwd, coords, shapes,
                                       multiscale, grad_out)),
               "first design": cs.timed(partial(cs.TRIPLANE_V1.sample_bwd, coords, shapes,
                                                multiscale, grad_out))}
        for name, lib in libs.items():
            if name.startswith("bwd"):
                for shared in (0, 2):
                    rec[f"{name}, {shared} shared LODs"] = cs.timed(partial(
                        bwd_with, lib, coords, shapes, grad_out, shared))
        print(json.dumps({"k18_recorded": rec}), flush=True)


def main() -> int:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("chip_triplane_bench: no CUDA device", file=sys.stderr)
        return 1
    from wisp_tpu_torch import kernels
    started = cs.start_baseline_build(cs.TRIPLANE_V1_SRC, "libwisp_triplane_v1.so")
    variants = start_variant_builds()
    kernels.build(verbose=True)
    cs.TRIPLANE_V1 = cs.TriplaneV1(started)
    libs = finish_variant_builds(variants)
    log = str(kernels.BUILD_INFO.get("log", ""))
    lines, keep = [], False
    for ln in log.splitlines():
        if ln.startswith("== "):
            keep = ln.strip() in ("== triplane.cu", "== integrate.cu")
        elif keep and ("registers" in ln or "spill" in ln or "Compiling" in ln):
            lines.append(ln.strip())
    print(json.dumps({"ptxas": lines}), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if "--phase" in sys.argv[1:]:
            rows, info = cs.new_grid_phase(dev, "triplanar", cs.TRIPLANAR_CONFIG,
                                           cs.TRIPLANAR_STEP_KERNELS,
                                           cs.TRIPLANAR_FRAME_KERNELS)
            print(json.dumps({"triplanar_rows": rows}), flush=True)
            print(json.dumps({"triplanar_step_ms_median": info["step_ms_median"],
                              "frame_ms": info["frame_ms"]}), flush=True)
            cs.triplane_design_phase()
            recorded_calls(libs)
            torch.cuda.empty_cache()
        synthetic_cases(dev, libs)
    except cs.SmokeFailure as e:
        print(f"chip_triplane_bench: FAILED: {e}", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
