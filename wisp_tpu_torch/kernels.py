"""Build, load and count the hand-written CUDA kernels in ``wisp_tpu_torch/csrc``.

The sources are compiled for Hopper (``sm_90a``) by ``nvcc`` into one shared library with a
plain C interface, loaded with ``ctypes``. Nothing is built when this module is imported:
the first wrapper that launches a kernel calls :func:`library`, which builds (one ``nvcc``
per source, all started together, then one link) into ``csrc/_build/<hash of the
sources>/`` and loads the result. Every C entry point launches on the stream it is given,
allocates nothing and returns ``cudaGetLastError()``.

``LAUNCHES`` counts the launches of each kernel wrapper. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels its path reached.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = CSRC / "_build"
LIB_NAME = "libwisp_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              # no fused multiply-add: the kernels then round every product and sum as
              # the plain PyTorch versions do, so cell and corner choices agree exactly
              "--fmad=false", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {"raymarch_ray": 0, "compact": 0, "scatter_back": 0,
                            "hashgrid_fwd": 0, "integrate_fwd": 0, "hashgrid_bwd": 0,
                            "scatter_back_bwd": 0, "integrate_bwd": 0, "scatter_max": 0,
                            "octree_query": 0, "free_space_distance": 0, "octree_interp": 0,
                            "sdf_walk": 0, "sphere_step": 0, "octree_interp_bwd": 0,
                            "mesh_sdf": 0, "raymarch_voxel": 0, "hashgrid_bwd_stoch": 0,
                            "compact_live": 0, "integrate_seg_fwd": 0, "integrate_seg_bwd": 0,
                            "scatter_max_acc": 0, "octree_query_search": 0,
                            "compact_rays": 0, "compact_rays_mid": 0, "scatter_rays": 0,
                            "scatter_rays_mid": 0, "closest_point": 0, "raymarch_uniform": 0,
                            "raytrace": 0, "spc_trace": 0, "hashgrid_query": 0,
                            "octree_query_interp": 0, "sphere_iter": 0, "triplane_fwd": 0,
                            "triplane_bwd": 0, "codebook_resolve": 0, "codebook_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # origins dirs jitter R S stride ustep dist_min dist_max cell_density level
    # samples depths mask dens deltas stream
    "wisp_raymarch_ray": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _I, _P, _P, _P, _P, _P,
                          _P],
    # origins dirs jitter R S K nc voxel step dist_min dist_max occ cell_density max_level
    # early_stop samples depths mask dens num_overflow stream
    "wisp_raymarch_voxel": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _P, _I, _F, _P,
                            _P, _P, _P, _P, _P],
    # mask acc_tau tau_cap samples dirs R S budget scratch group_totals done count idx cflat
    # cray_d stream
    "wisp_compact": [_P, _P, _F, _P, _P, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P],
    # v idx K C P out stream
    "wisp_scatter_back": [_P, _P, _L, _I, _L, _P, _P],
    # table (host: n rows of grad_out, grad_v, columns, row stride) n idx K P stream
    "wisp_scatter_back_bwd_many": [_P, _I, _P, _L, _L, _P],
    # coords table N dim F n_lods out_lods res scale hi begin dense codebook_size out stream
    "wisp_hashgrid_fwd": [_P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P, ctypes.c_uint32,
                          _P, _P],
    # coords grad_out u0_in u0_out N dim F n_lods out_lods res scale hi begin dense stoch
    # n_shared codebook_size grad_table stream
    "wisp_hashgrid_bwd": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                          ctypes.c_uint32, _P, _P],
    # density deltas depths mask color extra R S Ce bg0 bg1 bg2 rgb alpha depth hit
    # extra_out stream
    "wisp_integrate_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P,
                           _P, _P],
    # density deltas depths mask color R S bg0 bg1 bg2 g_rgb g_alpha g_depth grad_density
    # grad_color stream
    "wisp_integrate_bwd": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P, _P],
    # density deltas depths mask color extra acc_tau R S Ce rgb alpha depth extra_out acc_out
    # stream
    "wisp_integrate_seg_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                               _P],
    # density deltas depths mask color acc_tau R S g_rgb g_alpha g_depth g_acc grad_density
    # grad_color grad_acc stream
    "wisp_integrate_seg_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                               _P],
    # points density stride bf16 keep K level grid stream
    "wisp_scatter_max_points": [_P, _P, _L, _I, _P, _L, _I, _P, _P],
    # coords N level routes tables lens (host arrays) with_parents out stream
    "wisp_octree_query": [_P, _L, _I, _P, _P, _P, _I, _P, _P],
    # mask R budget origins dirs t t_far status ticket epoch count idx o_c d_c t_c tf_c
    # stream
    "wisp_compact_rays": [_P, _I, _L, _P, _P, _P, _P, _P, _P, ctypes.c_uint32, _P, _P, _P,
                          _P, _P, _P, _P],
    # table (host: n rows of v, out, row bytes) n idx K P stream
    "wisp_scatter_rows_many": [_P, _I, _P, _L, _L, _P],
    # occ level cap bits dist stream
    "wisp_free_space_distance": [_P, _I, _I, _P, _P, _P],
    # coords pidx N P col0 n_lods F lods (host struct) sum vec out stream
    "wisp_octree_interp": [_P, _P, _L, _I, _I, _I, _I, _P, _I, _I, _P, _P],
    # coords N query_level n_lods F lods (host struct) sum vec out cells stream
    "wisp_octree_query_interp": [_P, _L, _I, _I, _I, _P, _I, _I, _P, _P, _P],
    # origins dirs t alive hit t_far d d_stride free_dist N level step_size min_dis do_step
    # query_level n_lods F lods (host struct) sum vec group out out_stride xyz_col stream
    "wisp_sphere_iter": [_P, _P, _P, _P, _P, _P, _P, _L, _P, _L, _I, _F, _F, _I, _I, _I, _I,
                         _P, _I, _I, _I, _P, _L, _I, _P],
    # coords pidx N P col0 n_lods F trinkets grads levels shared_rows (host arrays) sum vec
    # grad_out stream
    "wisp_octree_interp_bwd": [_P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P],
    # points P tris T out stream
    "wisp_mesh_sdf": [_P, _L, _P, _I, _P, _P],
    # points P tris T dist nearest tidx stream
    "wisp_closest_point": [_P, _L, _P, _I, _P, _P, _P, _P],
    # origins dirs t alive t_far free_dist N level num_steps stream
    "wisp_sdf_walk": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    # origins dirs t alive hit t_far d free_dist N level step_size min_dis stream
    "wisp_sphere_step": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _P],
    # origins dirs N dist_min dist_max free_dist occ level num_steps route table len t hit
    # pidx num_overflow stream
    "wisp_spc_trace": [_P, _P, _L, _F, _F, _P, _P, _I, _I, _I, _P, _L, _P, _P, _P, _P, _P],
    # origins dirs R dist_min dist_max level route table len capacity max_steps pidx t_entry
    # t_exit mask overflow stream
    "wisp_raytrace": [_P, _P, _L, _F, _F, _I, _I, _P, _L, _I, _I, _P, _P, _P, _P, _P, _P],
    # coords table N dim F n_lods res hi begin rows dense (host arrays) codebook_size out
    # stream
    "wisp_hashgrid_query": [_P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P, ctypes.c_uint32, _P,
                            _P],
    # coords N n_lods out_lods F planes (host struct) sum vec out stream
    "wisp_triplane_fwd": [_P, _L, _I, _I, _I, _P, _I, _I, _P, _P],
    # coords N n_lods out_lods F grads (host struct) sum vec grad_out stream
    "wisp_triplane_bwd": [_P, _L, _I, _I, _I, _P, _I, _I, _P, _P],
    # n_lods K F mode lods (host struct) stream
    "wisp_codebook_resolve": [_I, _I, _I, _I, _P, _P],
    # n_lods K F mode shared lods (host struct) stream
    "wisp_codebook_bwd": [_I, _I, _I, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("wisp_tpu_torch: nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc process each, in parallel) and link them into
    one shared library; return its path. A library already built from the same sources
    and flags is reused. ``verbose`` adds ``-Xptxas -v`` (registers, spills) to the log,
    which is kept in ``BUILD_INFO`` and written beside the library as ``build.log``."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists() and not verbose:
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True, log="")
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("wisp_tpu_torch: nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                               *[str(o) for _, o, _ in procs]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("wisp_tpu_torch: linking the kernels failed\n" + link.stdout)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "build.log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib_path)
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - t0, cached=False,
                      log="\n".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.wisp_error_string.argtypes = [ctypes.c_int]
            lib.wisp_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, counter: str, *args) -> None:
    """Call C entry point ``name`` on the current stream, raise if the launch failed, and
    count it under ``counter``."""
    lib = library()
    # the raw stream, as PyTorch's generated code reads it: torch.cuda.current_stream()
    # costs tens of microseconds of host time, and a sphere-traced frame launches ~1,800
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    status = getattr(lib, name)(*args, stream)
    if status != 0:
        msg = lib.wisp_error_string(status).decode()
        raise RuntimeError(f"wisp_tpu_torch: kernel {name} failed to launch: {msg} "
                           f"(cudaError {status})")
    LAUNCHES[counter] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and ``shape``, where a
    dimension of None matches any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None:
        ok = t.ndim == len(shape)
        for s, d in zip(shape, t.shape):
            ok = ok and (s is None or s == d)
        if not ok:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def vector_width(f_dim: int, ptrs: Sequence[int]) -> int:
    """Features a lane of a kernel that moves 16-byte vectors where it can (K15 both ways,
    K18 both ways): 4 where F % 4 == 0 and every table (and cotangent) starts on 16 bytes,
    else 1."""
    return 4 if f_dim % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def pointers(tensors: Sequence[torch.Tensor]) -> ctypes.Array:
    """A host array of the tensors' device pointers, for an entry point that copies a list
    of tensors into its kernel's parameters; pass ``ctypes.addressof`` of it, and keep it
    alive until the call returns."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
