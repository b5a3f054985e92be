#!/usr/bin/env python3
"""Time K16 and K17 (``wisp_tpu_torch/csrc/mesh_sdf.cu``) on one NVIDIA GPU with one and
with two points a thread, beside their earlier design, and count the instructions of the
pair loop.

Run from the root of a checkout: ``python3 chip_mesh_bench.py``. It builds three copies of
the mesh kernels with the kernel library's ``nvcc`` and flags into
``wisp_tpu_torch/csrc/_build/mesh_bench/``: the source with its points-a-thread rule
(``points_per_thread``) forced to one and to two, and
``csrc/baselines/mesh_sdf_v1.cu``, the earlier design. It prints one JSON line for each
build (ptxas registers, spills and shared memory of each kernel), one for the pair loop
of ``closest_point_kernel<1>`` (its instructions by opcode, from ``cuobjdump -sass``: the
innermost loop that reads the tile with ``LDS.128``), one a call shape (K16 and K17 device
ms by CUDA events, 5 calls after a warm-up, the builds in turns, each result equal to the
first build's), then the card's name and power limit. The shapes: the NGLOD app's
icosphere (subdivision 3, 1,280 triangles) and 2,207,245 seeded points, half within 0.02
of a vertex and half in the box (the SDF train phase's resample count), and their first
100,000 and 50,000. It fails without a card. Nothing in the package calls it.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

RULE = "*ppt = wisp::ceil_div(P, 2 * kThreads) >= 2 * sms ? 2 : 1;"
POINTS = (2_207_245, 100_000, 50_000)


def build(kernels, name: str, source: str) -> tuple:
    """(library path, nvcc process) of one copy of a mesh source."""
    out_dir = kernels.BUILD_ROOT / "mesh_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(source)
    lib = out_dir / f"lib_{name}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
           str(kernels.CSRC), str(src), "-o", str(lib)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def ptxas(log: str) -> list:
    """Each kernel's registers, spills and static shared memory from ``-Xptxas -v``."""
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = re.search(r"(mesh_sdf_kernel|closest_point_kernel)(ILi(\d)E)?", line)
            out.append({"kernel": name.group(1) + (f"<{name.group(3)}>" if name.group(3)
                                                   else "")})
        elif out and "spill" in line:
            out[-1]["spill"] = line.strip()
        elif out and "registers" in line:
            out[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(smem.group(1)) if smem else 0
    return out


def pair_loop(sass: str) -> dict:
    """Opcode counts of the innermost loop of closest_point_kernel<1> that reads LDS.128,
    from ``cuobjdump -sass`` of a library."""
    func, text = None, []
    for line in sass.splitlines():
        if "Function :" in line:
            func = "closest_point_kernelILi1E" in line
        elif func:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                text.append((int(m.group(1), 16), m.group(2).strip()))
    best = None
    for addr, ins in text:
        m = re.search(r"BRA (0x[0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [i for a, i in text if int(m.group(1), 16) <= a <= addr]
        if any("LDS.128" in i for i in body) and (best is None or len(body) < len(best)):
            best = body
    if best is None:
        return {"pair_loop": "not found"}
    ops = {}
    for ins in best:
        op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
        op = op.split(".")[0]
        ops[op] = ops.get(op, 0) + 1
    return {"pair_loop_instructions": len(best),
            "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_mesh_bench: no CUDA device", file=sys.stderr)
        return 1
    from wisp_tpu_torch import kernels
    from wisp_tpu_torch.ops.mesh.compute_sdf import triangle_table
    from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
    from wisp_tpu_torch.ops.mesh.ops import normalize
    source = (kernels.CSRC / "mesh_sdf.cu").read_text()
    if RULE not in source:
        print("chip_mesh_bench: the points-a-thread rule is not in the source",
              file=sys.stderr)
        return 1
    earlier = (kernels.CSRC / "baselines" / "mesh_sdf_v1.cu").read_text()
    started = {"one point a thread": build(kernels, "ppt1",
                                           source.replace(RULE, "*ppt = 1;")),
               "two points a thread": build(kernels, "ppt2",
                                            source.replace(RULE, "*ppt = 2;")),
               "earlier design": build(kernels, "v1", earlier)}
    designs = {}
    for name, (lib, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        print(json.dumps({"build": name, "ptxas": ptxas(log)}), flush=True)
        cdll = ctypes.CDLL(str(lib))
        suffix = "_v1" if name == "earlier design" else ""
        k16 = getattr(cdll, "wisp_mesh_sdf" + suffix)
        k17 = getattr(cdll, "wisp_closest_point" + suffix)
        k16.argtypes = kernels._SIGNATURES["wisp_mesh_sdf"]
        k17.argtypes = kernels._SIGNATURES["wisp_closest_point"]
        designs[name] = (k16, k17)
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(started["one point a thread"][0])], stdout=subprocess.PIPE,
                          text=True).stdout
    print(json.dumps(pair_loop(sass)), flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    v, f = normalize(*make_sphere_mesh(1.0, subdivisions=3), "sphere")
    n = POINTS[0]
    near = v[rng.integers(0, len(v), n // 2)] + rng.normal(scale=0.02, size=(n // 2, 3))
    pts = np.concatenate([near, rng.uniform(-1.0, 1.0, (n - n // 2, 3))]).astype(np.float32)
    x_all = torch.from_numpy(pts[rng.permutation(n)]).to(dev)
    tris = triangle_table(v, f, dev)

    def run16(fn, x):
        out = torch.empty((x.shape[0],), dtype=torch.float32, device=dev)
        status = fn(x.data_ptr(), x.shape[0], tris.data_ptr(), tris.shape[0], out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        assert status == 0, status
        return (out,)

    def run17(fn, x):
        m = x.shape[0]
        outs = (torch.empty((m,), dtype=torch.float32, device=dev),
                torch.empty((m, 3), dtype=torch.float32, device=dev),
                torch.empty((m,), dtype=torch.int64, device=dev))
        status = fn(x.data_ptr(), m, tris.data_ptr(), tris.shape[0],
                    *(o.data_ptr() for o in outs), torch.cuda.current_stream().cuda_stream)
        assert status == 0, status
        return outs

    def ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    for m in POINTS:
        x = x_all[:m].contiguous()
        row = {"points": m, "triangles": tris.shape[0]}
        first = {}
        for name, (k16, k17) in designs.items():
            for kernel, runner, fn in (("K16", run16, k16), ("K17", run17, k17)):
                got = runner(fn, x)
                ref = first.setdefault(kernel, got)
                row[f"{kernel} {name} ms"] = ms(lambda: runner(fn, x))
                row[f"{kernel} {name} equal"] = all(torch.equal(a, b)
                                                     for a, b in zip(got, ref))
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
