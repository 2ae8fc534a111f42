"""Build, load and call the CUDA kernels.

The sources in ``fluid_simulation_tpu_torch/csrc`` compile with ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and link into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``<checkout>/build/fst_kernels/<hash>/``, keyed
on a hash of the sources and flags, so a fresh checkout builds itself and an
edited source rebuilds. Importing this module needs neither ``nvcc`` nor a
card.

A launch (``launch``) passes pointers as plain ints, reads the current
stream's raw handle at each call and enters a device guard only off the
current device: the host pays for the checks, the output's allocation, one
ctypes call and the CUDA launch, and nothing else.

``-fmad=false`` keeps every ``a*b+c`` as two roundings, as the plain torch
versions compute it; the sources also spell the critical expressions with
``__fmul_rn``/``__fadd_rn``, so each kernel matches its plain version bit
for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "fst_kernels"
LIB_NAME = "libfst_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: each launches on the given stream and returns
# cudaGetLastError() as an int
SIGNATURES = {
    "fst_rbgs_half": (_P, _P, _I, _I, _I, _F, _F, _I, _I, _P),
    "fst_rbgs_half_keep": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                           _P),
    "fst_keep_red": (_P, _P, _I, _I, _I, _I, _I, _P),
    "fst_rbgs_half3": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                       _F, _I, _I, _P),
    "fst_keep_red3": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "fst_rbgs_half_unpacked": (_P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P),
    "fst_keep_edges": (_P, _P, _I, _I, _I, _I, _P),
    "fst_trilinear_gather": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "fst_advect_compat": (_P,) * 7 + (_I, _I, _I, _F, _F, _F, _I, _P),
    "fst_advect_fast": (_P,) * 7 + (_I, _I, _I, _F, _F, _F, _P),
    "fst_divergence": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    "fst_grad_faces": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P),
    "fst_divergence_masked": (_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _F,
                              _P),
    "fst_grad_faces_masked": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I,
                              _I, _I, _F, _F, _I, _P),
    "fst_lerp_pass": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _F, _F, _P),
    "fst_pad_bounds": (_P, _P, _I, _I, _I, _I, _I, _P),
    "fst_pad_bounds_masked": (_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I,
                              _I, _I, _P),
    "fst_curl": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "fst_confine": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I,
                    _F, _P),
    "fst_rbgs_sweep1": (_P, _P, _I, _I, _P, _I, _I, _I, _F, _F, _P),
    "fst_rbgs_pass": (_P, _P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _F, _F, _I,
                      _I, _P),
    "fst_march_blocks_per_sm": (_I, _I, _I, _P),
    "fst_div_packed": (_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _F, _P),
    "fst_grad_packed": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _F, _F,
                        _P),
    "fst_sweep_packed_red": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _F, _F, _P),
    "fst_sweep_packed_black": (_P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _F, _F, _I, _P),
    "fst_sweep_half": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P),
    "fst_sweep_finish": (_P, _P, _I, _I, _I, _I, _P),
    "fst_prestep": (_P,) * 8 + (_P, _I, _I, _P, _I, _I) + (_I,) * 4
    + (_F,) * 6 + (_I, _I, _P),
    "fst_prestep_blocks": (_P,),
    "fst_cpack_red": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P),
    "fst_cpack_black": (_P, _P, _P, _I, _I, _I, _F, _F, _I, _P),
    "fst_probe_add1": (_P, _P, _I, _P),
    "fst_hbm_stream": (_P, _P, _P) + (_I,) * 9 + (_P,),
    "fst_sweepcost_pass": (_P, _P, _I, _I, _P, _I, _I, _I, _F, _F, _I, _I,
                           _I, _P),
    "fst_dma_stream": (_P,) * 7 + (_I,) * 11 + (_P,),
    "fst_dma_encode": (_P, _P, _I, _I, _I, _I, _I),
    "fst_transpose": (_P, _P, _I, _I, _I, _L, _L, _L, _P),
    "fst_strided_copy": (_P, _P, _I, _I, _I, _L, _L, _L, _F) + (_I,) * 7
    + (_P,),
    "fst_rbgs_half_mxu": (_P, _P, _I, _I, _I, _F, _F, _I, _P),
    "fst_lerpcost_pass": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "fst_step_stats": (_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                       _F, _I, _I, _P),
    # no-ops with the signatures of fst_probe_add1 and fst_trilinear_gather
    # (tools/exp_overhead.py's host split)
    "fst_probe_noop": (_P, _P, _I, _P),
    "fst_probe_noop9": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
}


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. Each source compiles in its own ``nvcc`` process, all
    at once, and the objects link into the library. The compiler's report
    (registers, spills) is kept in ``nvcc.log`` beside it."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        cu = [s for s in sources() if s.suffix == ".cu"]
        objs = [work / (src.stem + ".o") for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objs)]
        logs = []
        for src, proc in zip(cu, procs):
            out, _ = proc.communicate()
            logs.append((src.name, out, proc.returncode))
        tmp = work / LIB_NAME
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(("link", link.stdout + link.stderr, link.returncode))
        (out_dir / "nvcc.log").write_text(
            "".join(f"== {name} (rc {rc})\n{out}" for name, out, rc in logs))
        failed = [(name, out) for name, out, rc in logs if rc != 0]
        if failed:
            name, out = failed[0]
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-4000:]}")
        os.replace(tmp, lib)   # atomic: concurrent builds agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


# C entry point name -> its ctypes function, filled once by library(), so
# that a launch looks its function up in one dict
_ENTRY = {}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, then cached)."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
        _ENTRY[name] = fn
    lib.fst_error_string.argtypes = [ctypes.c_int]
    lib.fst_error_string.restype = ctypes.c_char_p
    return lib


def _entry(name: str):
    """The ctypes function of C entry point ``name`` (the library is
    loaded, and ``_ENTRY`` filled, at the first lookup)."""
    fn = _ENTRY.get(name)
    if fn is None:
        library()
        fn = _ENTRY[name]
    return fn


def call(name: str, *args) -> None:
    """Call C entry point ``name`` with ``args`` as they are, on no stream
    (a query such as ``fst_prestep_blocks``, ``fst_march_blocks_per_sm``);
    raise if it returned an error."""
    rc = _entry(name)(*args)
    if rc != 0:
        _raise(name, rc)


def launch(name: str, device: int, *args) -> None:
    """Launch C entry point ``name`` on CUDA device ``device`` (an index,
    ``t.get_device()``) with ``args`` and that device's current stream, read
    at this call (a CUDA graph's capture stream while one captures); raise
    if the launch reported an error. Pointers are plain ints (``ptr``),
    None for a null one. The device guard is entered only when ``device``
    is not the current device."""
    fn = _entry(name)
    C = torch._C
    if device == C._cuda_getDevice():
        rc = fn(*args, C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, C._cuda_getCurrentRawStream(device))
    if rc != 0:
        _raise(name, rc)


def _raise(name: str, rc: int):
    msg = library().fst_error_string(rc).decode()
    raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def on_card(t: torch.Tensor) -> bool:
    """True when ``t`` lives on a CUDA device, so its kernel must launch."""
    return t.is_cuda


def check_operands(name: str, tensors, shapes=None,
                   dtypes=(torch.float32,)) -> None:
    """Raise unless every operand is a contiguous tensor on the card (one
    device) of one of ``dtypes`` (float32 unless the kernel takes more),
    with the expected shape where ``shapes`` gives one."""
    dev = tensors[0].get_device()
    for i, t in enumerate(tensors):
        if not on_card(t) or t.get_device() != dev:
            raise ValueError(f"{name}: operand {i} on {t.device}, expected "
                             f"the card ({tensors[0].device})")
        if t.dtype not in dtypes:
            raise NotImplementedError(
                f"{name}: {t.dtype} is not ported to the card yet (ROADMAP "
                f"A11); this kernel takes {', '.join(map(str, dtypes))}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} is not contiguous")
        if shapes is not None and shapes[i] is not None \
                and t.shape != tuple(shapes[i]):
            raise ValueError(f"{name}: operand {i} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shapes[i])}")


def mask_view(name: str, m: torch.Tensor, shape, device: int):
    """``(pointer, z stride, y stride)`` of an interior-shaped (D, H, W)
    float32 mask on the card ``device`` (an index): a contiguous interior
    array or an interior view of a padded one (``keep[1:-1, 1:-1, 1:-1]``).
    Raises unless its shape is ``shape`` and its x stride is 1."""
    shape = tuple(shape)
    if m.get_device() != device:
        where = f"cuda:{device}" if device >= 0 else "cpu"
        raise ValueError(f"{name}: mask on {m.device}, expected {where}")
    if m.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: {m.dtype} mask is not ported to the card yet (ROADMAP "
            f"A11); only float32 kernels exist")
    if m.shape != shape or m.stride(2) != 1:
        raise ValueError(f"{name}: mask of shape {tuple(m.shape)} and strides "
                         f"{m.stride()}, expected {shape} with x stride 1")
    return m.data_ptr(), m.stride(0), m.stride(1)


# a tensor's address as a plain int, which the c_void_p argtypes take
ptr = torch.Tensor.data_ptr


@functools.cache
def sm_count(device: int) -> int:
    """Streaming multiprocessors of CUDA device ``device`` (an index)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def neg_mask(signs_per_field) -> int:
    """Pack ghost-face signs: bit ``3*field + axis`` (axis 0 = x, 1 = y,
    2 = z) is set where that face mirrors negated."""
    if len(signs_per_field) > 10:
        raise ValueError("at most 10 fields fit a 32-bit sign mask")
    m = 0
    for i, signs in enumerate(signs_per_field):
        for axis, s in enumerate(signs):
            if s < 0:
                m |= 1 << (3 * i + axis)
    return m
