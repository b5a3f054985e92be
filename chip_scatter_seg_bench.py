#!/usr/bin/env python3
"""Time K12's scatter-back and K6b (``wisp_tpu_torch/csrc/compaction.cu``,
``csrc/integrate.cu``) on one NVIDIA GPU in variants of their designs, beside their earlier
designs.

Run from the root of a checkout: ``python3 chip_scatter_seg_bench.py``. It builds edited
copies of the two sources with the kernel library's ``nvcc`` and flags into
``wisp_tpu_torch/csrc/_build/scatter_seg_bench/``, each into its own library (entry points
of one name do not clash across ``ctypes.CDLL``s), and the earlier designs
(``csrc/baselines/scatter_rows_v1.cu``, ``integrate_seg_v1.cu``). The variants:

- the scatter-back: "rows first" (the source: one thread a slot loads its index and every
  channel's row before it stores any) and "channels in turn" (one thread a slot copies
  the channels one after another, each row's loads before its stores);
- K6b: "vec4" (the source: 4 steps a lane, vector loads where aligned), "vec4 scalar" (its
  scalar loads), "vec2" (2 steps a lane, scalar loads), "per-step extras" (the extra
  columns' predicated code run every round whatever Ce is, as the first build of the
  redesign ran it inside its step loop), "factored" (w = exp(-(A + base)) *
  exp(-(prefix - tau)) * (1 - exp(-tau)), so that the lane's exponentials need not wait for
  the scan) and "blocks of 128".

The shapes: the trained NGLOD frame's chunk (36,045 slots of 65,536 rays, all kept; t, xyz,
hit, normal) and its mid pass (19,661 slots of 36,045 rays, 5,644 kept; t, hit), seeded;
K6b on 2,048 rays of 128 steps (the seg segment; a tenth of the mask set, as at the seg
step) and of 512 and 2,048 steps. Each variant's result is held to the plain version (the
scatter bit for bit; K6b within 1e-4, acc_tau out 1e-5 relative), then timed
(``chip_smoke.timed``: device ms by torch.profiler, CUDA-event ms), the variants in turns,
two rounds. It prints one JSON line a build (ptxas registers and spills of each kernel),
one a shape and round, then the card's name and power limit. It fails without a card.
Nothing in the package calls it.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

sys.path.insert(0, ".")        # the checkout this is run from

import numpy as np
import torch

import chip_smoke as cs
from wisp_tpu_torch import kernels
from wisp_tpu_torch.ops.compaction import scatter_rows_many_plain
from wisp_tpu_torch.ops.integration import integrate_segment_plain

SCATTER_PRELOAD = "    if (c < tab.n && rb <= 16)\n"
SCATTER_SMALL = "    if (rb <= 16) {\n"
SEG_VEC = "constexpr int kSegVec = 4;"
SEG_VECTOR = "    const bool vector = S % kSegVec == 0 &&"
SEG_EXTRAS = "    if (Ce > 0) {\n#pragma unroll\n      for (int j = 0; j < kSegVec; ++j) {"
SEG_WEIGHT = ("        const float sum_prev = (base + incl[j]) - tau[j];\n"
              "        w[j] = expf(-(A + sum_prev)) * (1.0f - expf(-tau[j]));\n")
SEG_FACTORED = ("        w[j] = expf(-(A + base)) * expf(-(incl[j] - tau[j]))\n"
                "               * (1.0f - expf(-tau[j]));\n")
SEG_THREADS = "    const int threads = 256;\n    const unsigned blocks"


def edit(source: str, *pairs) -> str:
    for old, new in pairs:
        if source.count(old) != 1:
            raise SystemExit(f"chip_scatter_seg_bench: the edit {old!r} no longer matches")
        source = source.replace(old, new)
    return source


def variants() -> dict:
    """{(kernel, variant): source text}."""
    comp = (kernels.CSRC / "compaction.cu").read_text()
    seg = (kernels.CSRC / "integrate.cu").read_text()
    scalar = (SEG_VECTOR, "    const bool vector = false && S % kSegVec == 0 &&")
    return {
        ("scatter", "rows first"): comp,
        ("scatter", "channels in turn"): edit(comp, (SCATTER_PRELOAD, "    if (false)\n"),
                                              (SCATTER_SMALL, "    if (false) {\n")),
        ("seg", "vec4"): seg,
        ("seg", "vec4 scalar"): edit(seg, scalar),
        ("seg", "vec2"): edit(seg, scalar, (SEG_VEC, "constexpr int kSegVec = 2;")),
        ("seg", "per-step extras"): edit(seg, (SEG_EXTRAS, SEG_EXTRAS.replace(
            "if (Ce > 0)", "if (true)"))),
        ("seg", "factored"): edit(seg, (SEG_WEIGHT, SEG_FACTORED)),
        ("seg", "blocks of 128"): edit(seg, (SEG_THREADS, SEG_THREADS.replace("256", "128"))),
    }


def build_all(sources: dict) -> dict:
    """{(kernel, variant): (library, ptxas lines)}, nvcc started for all at once."""
    out_dir = kernels.BUILD_ROOT / "scatter_seg_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, text) in enumerate(sources.items()):
        src = out_dir / f"v{i}.cu"
        src.write_text(text)
        lib = out_dir / f"libv{i}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
               str(kernels.CSRC), str(src), "-o", str(lib)]
        procs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:          # a variant that does not build is reported, not run
            print(json.dumps({"build": list(key), "failed": log[-2000:]}), flush=True)
            continue
        lines, regs, name = log.splitlines(), [], None
        for ln in lines:
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = m.group(1)
            elif name and ("scatter_rows_many" in name or "integrate_seg" in name) and (
                    "registers" in ln or "spill" in ln):
                regs.append((name[-40:], ln.strip()))
        built[key] = (ctypes.CDLL(str(lib)), regs)
    return built


def stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def scatter_call(lib, idx, pairs):
    fn = lib.wisp_scatter_rows_many
    fn.argtypes = kernels._SIGNATURES["wisp_scatter_rows_many"]
    fn.restype = ctypes.c_int
    rows = []
    for v, out in pairs:
        rows += [v.data_ptr(), out.data_ptr(), int(np.prod(v.shape[1:])) * v.element_size()]
    table = (ctypes.c_longlong * len(rows))(*rows)
    k, p = pairs[0][0].shape[0], pairs[0][1].shape[0]

    def call():
        status = fn(ctypes.addressof(table), len(pairs), idx.data_ptr(), k, p, stream())
        cs.require(status == 0, f"wisp_scatter_rows_many failed to launch ({status})")
        return [out for _, out in pairs]
    return call


def seg_call(lib, args):
    fn = lib.wisp_integrate_seg_fwd
    fn.argtypes = kernels._SIGNATURES["wisp_integrate_seg_fwd"]
    fn.restype = ctypes.c_int
    density, deltas, depths, mask, color, acc = args
    r, s = density.shape
    out = {k: torch.empty(shape, device=density.device) for k, shape in (
        ("rgb", (r, 3)), ("alpha", (r, 1)), ("acc_tau", (r,)), ("depth", (r, 1)))}

    def call():
        status = fn(density.data_ptr(), deltas.data_ptr(), depths.data_ptr(), mask.data_ptr(),
                    color.data_ptr(), None, acc.data_ptr(), r, s, 0, out["rgb"].data_ptr(),
                    out["alpha"].data_ptr(), out["depth"].data_ptr(), None,
                    out["acc_tau"].data_ptr(), stream())
        cs.require(status == 0, f"wisp_integrate_seg_fwd failed to launch ({status})")
        return out
    return call


def scatter_shape(gen, dev, slots, rays, kept, widths):
    """Slots of the compaction's contract: the kept rays in order, then empty ones."""
    idx = torch.cat([torch.randperm(rays, generator=gen)[:kept].sort().values,
                     torch.full((slots - kept,), rays, dtype=torch.int64)])
    pairs = []
    for w in widths:
        if w == 1:
            v = torch.rand(slots, generator=gen) < 0.5
            b = torch.rand(rays, generator=gen) < 0.5
        else:
            shape = () if w == 4 else (w // 4,)
            v = torch.randn((slots,) + shape, generator=gen)
            b = torch.randn((rays,) + shape, generator=gen)
        pairs.append((v.to(dev), b.to(dev)))
    return idx.to(dev), pairs


def seg_shape(gen, dev, r, s):
    return ((torch.rand(r, s, generator=gen) * 20.0).to(dev),
            (torch.rand(r, generator=gen) * 0.02).to(dev),
            torch.rand(r, s, generator=gen).cumsum(-1).to(dev),
            (torch.rand(r, s, generator=gen) < 0.1).to(dev),
            torch.rand(r, s, 3, generator=gen).to(dev),
            (torch.rand(r, generator=gen) * 3.0).to(dev))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_scatter_seg_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernels.build()
    started = (cs.start_baseline_build(cs.SCATTER_ROWS_V1_SRC, "libwisp_scatter_rows_v1.so"),
               cs.start_baseline_build(cs.INTEGRATE_SEG_V1_SRC, "libwisp_integrate_seg_v1.so"))
    built = build_all(variants())
    v1 = cs.ScatterSegV1(*started)
    for key, (_, ptx) in built.items():
        print(json.dumps({"build": list(key), "ptxas": ptx}), flush=True)
    gen = torch.Generator(device="cpu").manual_seed(0)
    shapes = {"chunk": scatter_shape(gen, dev, 36045, 65536, 36045, (4, 12, 1, 12)),
              "mid pass": scatter_shape(gen, dev, 19661, 36045, 5644, (4, 1))}
    for rnd in range(2):
        for name, (idx, pairs) in shapes.items():
            want = scatter_rows_many_plain(idx, [(v, b.clone()) for v, b in pairs])
            cs.require(cs.scatter_equal(v1.scatter_rows_many(idx, [(v, b.clone())
                                                                   for v, b in pairs]), want),
                       "the earlier scatter design differs")
            work_v1 = [(v, b.clone()) for v, b in pairs]
            calls = {"was (a launch a channel)":
                     lambda: v1.scatter_rows_many(idx, work_v1)}
            line = {"shape": f"scatter {name}", "round": rnd}
            for (kernel, var), (lib, _) in built.items():
                if kernel == "scatter":
                    got = scatter_call(lib, idx, [(v, b.clone()) for v, b in pairs])()
                    cs.require(cs.scatter_equal(got, want), f"scatter {var} differs")
                    calls[var] = scatter_call(lib, idx, [(v, b.clone()) for v, b in pairs])
            for var, call in calls.items():
                line[var] = cs.timed(call)
            print(json.dumps(line), flush=True)
        for steps in (128, 512, 2048):
            args = seg_shape(gen, dev, 2048, steps)
            want = integrate_segment_plain(*args)
            line = {"shape": f"K6b 2048 x {steps}", "round": rnd}
            calls = {"was (32 steps a round)": lambda: v1.integrate_segment(*args)}
            for (kernel, var), (lib, _) in built.items():
                if kernel == "seg":
                    call = seg_call(lib, args)
                    cs.require(cs.seg_fwd_within(call(), want), f"K6b {var} is off")
                    calls[var] = call
            cs.require(cs.seg_fwd_within(v1.integrate_segment(*args), want),
                       "the earlier K6b design is off")
            for var, call in calls.items():
                line[var] = cs.timed(call)
            print(json.dumps(line), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
