"""Build the CUDA sources in ``tpurt_torch/csrc`` and bind them with ctypes.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more call links the objects into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -Xptxas -v -c csrc/<kernel>.cu -o <kernel>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <name>.so *.o

``--fmad=false`` keeps every multiply and add separately rounded, which is
what makes the kernels bit-comparable with their plain PyTorch versions.
The library lands in ``tpurt_torch/_build/`` (ignored by git), named by a
hash of the sources, and is built at first use. Pointers and the stream are
passed as ``c_void_p``; every C entry returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.

Each kernel wrapper counts its launches in :data:`launch_counts`, and
``engine/frame_graph.py`` its launches of render()'s CUDA graph;
:data:`KERNEL_OF` names the CUDA function each counter's launches run (its
name in a ``torch.profiler`` trace, before any template arguments), so a
profile counts what a graph replay ran. :func:`device_ms` times a
wrapper's launches on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# one plain integer per kernel entry point (and per GTAO variant), bumped
# only where it launches; bvh8_closest_steps / bvh8_any_steps count every
# K7a launch, counted or with another push order
launch_counts = {"bvh8_closest": 0, "bvh8_any": 0, "gtao_noise": 0,
                 "gtao_main": 0, "gtao_denoise": 0,
                 # the GTAO variants' instantiations (kernels/gtao_main.py,
                 # kernels/gtao_denoise.py)
                 "gtao_noise_fp16": 0, "gtao_main_bent": 0,
                 "gtao_main_half": 0, "gtao_main_fp16": 0,
                 "gtao_main_bent_fp16": 0, "gtao_denoise_bent": 0,
                 "gtao_denoise_fp16": 0, "gtao_denoise_bent_fp16": 0,
                 # K3 over a band of rows other than the whole image, in
                 # any instantiation (the band-sharded frame's GTAO)
                 "gtao_main_band": 0,
                 "bvh2_closest": 0, "bvh2_any": 0, "bvh8_any_multi": 0,
                 "bvh8_any_multi_pop2": 0,
                 "bvh8_closest_pop2": 0, "bvh8_any_pop2": 0,
                 "bvh8_closest_uvp": 0, "bvh8_closest_steps": 0,
                 "bvh8_any_steps": 0, "trans_equiv": 0,
                 # K8a and K8b, shade's light loop (kernels/shade_lights.py)
                 "shade_light_rays": 0, "shade_light_sum": 0,
                 # K9, a mip scene's texel fetch (kernels/mip_texels.py),
                 # and the rows it reads where a gather hook serves them
                 "mip_texels": 0, "mip_texel_rows": 0,
                 # K10, shade's surface reconstruction (kernels/
                 # shade_surface.py): the kernel or pre-pass once per
                 # shade() call, the epilogue where K9 or a hook's rows
                 # come between
                 "shade_surface": 0, "shade_surface_nmap": 0,
                 # launches of render()'s frame as one CUDA graph
                 # (engine/frame_graph.py), one a replayed frame: the
                 # kernels the graph runs count nowhere here
                 "frame_graph": 0}
# the CUDA function each kernel counter's launches run
KERNEL_OF = {
    **dict.fromkeys(("bvh8_closest", "bvh8_closest_uvp"),
                    "bvh8_closest_kernel"),
    "bvh8_any": "bvh8_any_kernel",
    **dict.fromkeys(("gtao_noise", "gtao_noise_fp16"), "gtao_noise_kernel"),
    **dict.fromkeys(("gtao_main", "gtao_main_bent", "gtao_main_half",
                     "gtao_main_fp16", "gtao_main_bent_fp16",
                     "gtao_main_band"), "gtao_main_kernel"),
    **dict.fromkeys(("gtao_denoise", "gtao_denoise_bent",
                     "gtao_denoise_fp16", "gtao_denoise_bent_fp16"),
                    "gtao_denoise_kernel"),
    **dict.fromkeys(("bvh2_closest", "bvh2_any"), "bvh2_trace_kernel"),
    **dict.fromkeys(("bvh8_any_multi", "bvh8_any_multi_pop2"),
                    "bvh8_any_multi_kernel"),
    **dict.fromkeys(("bvh8_closest_pop2", "bvh8_closest_steps"),
                    "bvh8_closest_variant_kernel"),
    **dict.fromkeys(("bvh8_any_pop2", "bvh8_any_steps"),
                    "bvh8_any_variant_kernel"),
    "trans_equiv": "trans_equiv_kernel",
    "shade_light_rays": "light_rays_kernel",
    "shade_light_sum": "light_sum_kernel",
    "mip_texels": "mip_texels_kernel",
    "mip_texel_rows": "mip_texel_rows_kernel",
    "shade_surface": "shade_surface_kernel",
    "shade_surface_nmap": "shade_surface_nmap_kernel"}

_LOCK = threading.Lock()
_LIB = None
build_log = ""


def reset_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def by_kernel(counts: dict) -> dict:
    """Kernel counters' launches summed by the CUDA function they run
    (:data:`KERNEL_OF`), leaving out those at 0."""
    out = {}
    for k, n in counts.items():
        if n and k in KERNEL_OF:
            out[KERNEL_OF[k]] = out.get(KERNEL_OF[k], 0) + n
    return out


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha1()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"tpurt_torch_kernels_{h.hexdigest()[:12]}.so"


def get_lib():
    """The loaded kernel library, compiled on first use. Raises on any build
    or load failure: there is no fallback."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            build_log = _compile(so)
            (BUILD_DIR / (so.stem + ".log")).write_text(build_log)
        else:
            log = BUILD_DIR / (so.stem + ".log")
            build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(so))
        lib.tpurt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tpurt_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def _compile(so: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    place; returns the compilers' output. Raises on any failure."""
    nvcc = nvcc_path()
    tag = f"{so.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate(timeout=600)
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True, timeout=600)
        log.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
    return text


def function(name: str, argtypes):
    """A C entry point of the library with its argument types set; every
    entry returns the CUDA error code of its launch."""
    fn = getattr(get_lib(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str):
    if err != 0:
        msg = get_lib().tpurt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(name: str, tensors: dict, device):
    """Device, contiguity checks shared by the wrappers' kernel branch."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def pick_stack(need: int, sizes, tree: str, kernel: str) -> int:
    """The least of the ascending stack instantiations `sizes` that holds
    `need` entries; refuses a `tree` that needs more than `kernel` holds."""
    for size in sizes:
        if need <= size:
            return size
    raise ValueError(f"{tree} needs {need} stack entries; {kernel} holds at "
                     f"most {sizes[-1]}")


# cycles of the spin kernel queued ahead of a timed run (about 2.5 ms at
# the H100's 1.98 GHz): longer than the host takes to enqueue the run
QUEUE_AHEAD_CYCLES = 5_000_000


def device_ms(fn, reps: int = 10) -> float:
    """Device ms of fn(), a kernel wrapper's call: CUDA events around
    `reps` calls, the mean per call, the least of 3 runs (a delay only ever
    adds time), after 3 warm-up calls. A spin kernel (torch.cuda._sleep)
    queued first keeps the card busy while the host enqueues each run, so
    a launch shorter than its wrapper's host path is timed on the card,
    not at the host's pace."""
    import torch

    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best
