"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use, by its own ``nvcc`` process (all of them started together), into
``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root.  The
hash covers the source, the headers of ``csrc/`` and the compiler flags, so
an edited kernel is rebuilt and an unchanged one is reused.  The libraries
are loaded with ``ctypes`` with each entry's own argument types
(``_ARGTYPES``): pointers and the stream go in as ``c_void_p``, sizes and
flags as ``c_int``, scales as ``c_float``, and every entry returns
``cudaGetLastError()`` after its launch.  ``ptxas -v`` reports each
kernel's registers, shared memory and spills; a build keeps that report in
``BUILD_LOG`` (:func:`ptxas_report` parses it).

Nothing here runs when the module is imported: a machine without ``nvcc``
or a card imports it, and only a launch on a CUDA tensor needs them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
KERNELS = ("lstm_cell", "gru_cell", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# argument types of each C entry: the data pointers (inputs, then outputs),
# then its sizes, flags and scales; the stream follows them all
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # M (clients), T, B, I, H, then the CellPlan: cluster, rows,
    # rows_per_thread, k_split, threads
    "lstm_cell": [_P] * 8 + [_I] * 10,
    "gru_cell": [_P] * 6 + [_I] * 10,
    # B, S, Hq, Hkv, hd, window; scale
    "flash_attention": [_P] * 4 + [_I] * 6 + [_F],
}

# launches per kernel; each wrapper adds one right after its launch
LAUNCHES: Counter = Counter()
# nvcc's stderr (the ptxas report) of each source compiled by this process
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    args = _ARGTYPES[name] + [_P]
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"repro_{name}_{suffix}")
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def build(names: Sequence[str] = KERNELS) -> Dict[str, ctypes.CDLL]:
    """Compile (where the cached library is missing) and load ``names``.

    One ``nvcc`` per source, all started before any is awaited.  A failed
    build raises with nvcc's stderr.  Thread-safe; later calls return the
    loaded libraries at once.
    """
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {n: _libs[n] for n in names}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in todo:
            path = _library_path(name)
            if path.exists():
                continue
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            jobs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, path, tmp, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on csrc/{name}.cu "
                              f"(exit {proc.returncode}):\n{err}")
            else:
                BUILD_LOG[name] = err
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            _libs[name] = _bind(name, _library_path(name))
        return {n: _libs[n] for n in names}


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_NUMBERS = {
    "stack_bytes": re.compile(r"(\d+) bytes stack frame"),
    "spill_store_bytes": re.compile(r"(\d+) bytes spill stores"),
    "spill_load_bytes": re.compile(r"(\d+) bytes spill loads"),
    "registers": re.compile(r"Used (\d+) registers"),
    "static_smem_bytes": re.compile(r"(\d+) bytes smem"),
}


def ptxas_report(log: str) -> List[dict]:
    """One dict per kernel of a ``ptxas -v`` report: its mangled name and
    the numbers ptxas printed for it (registers, stack, spills, static
    shared memory)."""
    out: List[dict] = []
    for line in log.splitlines():
        entry = _PTXAS_ENTRY.search(line)
        if entry:
            out.append({"kernel": entry.group(1)})
            continue
        if not out:
            continue
        for key, pat in _PTXAS_NUMBERS.items():
            found = pat.search(line)
            if found:
                out[-1][key] = int(found.group(1))
    return out


# The recurrent-layer kernels (csrc/recurrent_layer.cuh) hold a block's
# weights in shared memory; where one block cannot, a cluster of blocks
# splits the hidden columns.  The range of shapes is what 8 blocks hold.
SMEM_LIMIT = 232448          # dynamic shared memory one sm_90 block opts into
CLUSTERS = (1, 2, 4, 8)      # blocks splitting the columns; 8 is portable
MAX_ROWS = 4                 # batch rows per block
X_REGS = 4                   # x values a thread carries to the next step
MAX_THREADS = 512            # per block (__launch_bounds__ of the kernels)
MAX_CLIENTS = 65535          # clients of one launch (gridDim.z)
GATES = {"lstm_cell": 4, "gru_cell": 3}
ROWS_PER_THREAD = 2          # batch rows of one thread (the kernels take 1, 2)
K_SPLIT = 4                  # lanes sharing a column's sums (they take 2, 4)


class CellPlan(NamedTuple):
    """How a layer kernel is launched: ``cluster`` blocks split the hidden
    columns, each owns ``rows`` batch rows, a thread ``rows_per_thread`` of
    them; ``k_split`` lanes share a column's sums over k (and each finishes
    at most one row); ``threads`` per block."""
    cluster: int
    rows: int
    rows_per_thread: int
    k_split: int
    threads: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _columns(H: int, cluster: int) -> int:
    return H if cluster == 1 else _round_up(-(-H // cluster), 8)


def cell_smem_bytes(gates: int, I: int, H: int, cluster: int, rows: int,
                    itemsize: int) -> int:
    """Dynamic shared memory of one block (``layer::Layout`` in
    csrc/recurrent_layer.cuh): the copy's mbarrier, W (kw rows of
    gates * hc, padded to a stride of 16 mod 64 bytes) and the bias in the
    input dtype, two fp32 row buffers of [x | h]."""
    hc, kw = _columns(H, cluster), _round_up(I, 4) + _round_up(H, 4)
    ws = gates * hc + (16 - gates * hc * itemsize) % 64 // itemsize
    return (16 + kw * ws * itemsize + _round_up(gates * hc * itemsize, 16)
            + 4 * 2 * rows * kw)


def _cluster(gates: int, I: int, H: int, itemsize: int):
    """The fewest blocks whose shared memory holds the weights, or None."""
    for cluster in CLUSTERS:
        if cell_smem_bytes(gates, I, H, cluster, MAX_ROWS,
                           itemsize) <= SMEM_LIMIT:
            return cluster
    return None


def cell_dims(name: str, x_seq: torch.Tensor,
              h: torch.Tensor) -> Tuple[int, int, int, int]:
    """(T, B, I, H) of one client's layer call, raising outside the
    kernels' range: T, B, I, H >= 1 and weights that 8 blocks' shared
    memory holds (in fp32 H <= 256 at any I <= 64 for both cells).  x_seq is
    (T, B, I) with h (B, H), or (M, T, B, I) with h (M, B, H) for M clients
    (1 <= M <= ``MAX_CLIENTS``), each with its own weights."""
    if not ((x_seq.dim() == 3 and h.dim() == 2)
            or (x_seq.dim() == 4 and h.dim() == 3)):
        raise ValueError(f"{name}: x_seq must be 3-D (T, B, I) with h 2-D, "
                         f"or 4-D (M, T, B, I) with h 3-D, got "
                         f"{tuple(x_seq.shape)} and {tuple(h.shape)}")
    (T, B, I), H = x_seq.shape[-3:], h.shape[-1]
    M = x_seq.shape[0] if x_seq.dim() == 4 else 1
    itemsize = 2 if x_seq.dtype == torch.bfloat16 else 4
    if (min(M, T, B, I, H) < 1 or M > MAX_CLIENTS
            or MAX_ROWS * I > X_REGS * MAX_THREADS
            or _cluster(GATES[name], I, H, itemsize) is None):
        raise ValueError(
            f"{name}: M={M}, T={T}, B={B}, I={I}, H={H} outside the "
            f"kernel's range (M, T, B, I, H >= 1, M <= {MAX_CLIENTS}, "
            f"I <= {X_REGS * MAX_THREADS // MAX_ROWS}, "
            f"and the weights within {max(CLUSTERS)} blocks' shared memory "
            f"of {SMEM_LIMIT} bytes each)")
    return T, B, I, H


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def cell_plan(name: str, B: int, I: int, H: int, itemsize: int, sms: int,
              rows: int = 0, rows_per_thread: int = 0,
              k_split: int = 0, M: int = 1) -> CellPlan:
    """The launch plan of a layer call (sizes from :func:`cell_dims`, the
    input dtype's ``itemsize``, ``M`` clients) on a card of ``sms`` SMs: the
    fewest cluster blocks that hold the weights; as few rows a block as keep
    one wave of the ``M x ceil(B / rows) x cluster`` blocks on the SMs, at
    most ``MAX_ROWS``; ``ROWS_PER_THREAD`` of them a
    thread; ``K_SPLIT`` lanes a column, 2 where 4 would pass
    ``MAX_THREADS``; and the threads that cover the block's columns and
    rows.  ``rows``, ``rows_per_thread`` and ``k_split`` replace the
    choice, for measuring the others (``chip_smoke.py`` phase 4)."""
    cluster = _cluster(GATES[name], I, H, itemsize)
    hc = _columns(H, cluster)
    if not rows:
        need = -(-M * B * cluster // sms)
        rows = min(MAX_ROWS, 1 << max(0, need - 1).bit_length())
    rpt = rows_per_thread or min(rows, ROWS_PER_THREAD)
    ks = k_split or (K_SPLIT if hc * K_SPLIT * (rows // rpt) <= MAX_THREADS
                     else 2)
    threads = max(hc * ks * (rows // rpt), -(-rows * I // X_REGS), 32)
    plan = CellPlan(cluster, rows, rpt, ks, _round_up(threads, 32))
    if (rows > MAX_ROWS or rows % rpt or rpt not in (1, 2)
            or ks not in (2, 4) or plan.threads > MAX_THREADS):
        raise ValueError(f"{name}: launch plan {plan} outside the kernel's "
                         "range")
    return plan


def check_inputs(name: str, tensors: Sequence[torch.Tensor],
                 shapes: Sequence[Tuple[int, ...]]) -> None:
    """Raise unless every tensor lies on one CUDA device, has one dtype
    (float32 or bfloat16), has its expected shape and is contiguous, and
    unless autograd would have to record the launch: a launch itself is
    forward only, and the wrappers route what autograd records through
    their ``torch.autograd.Function`` (whose forward runs with grad mode
    off)."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dt} is not float32 or bfloat16")
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        if t.device != dev:
            raise ValueError(f"{name}: argument {i} on {t.device}, not {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, not {dt}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: argument {i} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name}: a direct launch is forward only; call the "
                "wrapper, whose autograd Function records it, or run under "
                "torch.no_grad()")


def launch(name: str, tensors: Sequence[torch.Tensor],
           scalars: Sequence) -> None:
    """Launch ``name`` on the current stream of the tensors' device with
    data pointers ``tensors`` (inputs, then outputs) and ``scalars`` (sizes,
    flags, scales, as ``_ARGTYPES`` lists them); raise if the launch is
    refused.  The tensors' device is current only for the launch, so the
    caller's current device is left as it was."""
    lib = _libs.get(name) or build((name,))[name]
    dev = tensors[0].device
    suffix = "f32" if tensors[0].dtype == torch.float32 else "bf16"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"repro_{name}_{suffix}")(
            *[t.data_ptr() for t in tensors], *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} ({lib.repro_error_string(err).decode()})")
