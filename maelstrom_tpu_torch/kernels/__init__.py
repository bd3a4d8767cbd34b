"""Builds, loads and launches the port's hand-written CUDA kernels.

The sources live in `maelstrom_tpu_torch/csrc/*.cu`. At first use each is
compiled by its own `nvcc` (all started together) for `sm_90a` and linked
into one shared library with a plain C interface, loaded with `ctypes`.
The library lands in `maelstrom_tpu_torch/_build/`, named by a hash of the
sources, so editing a source rebuilds it. Nothing is built or imported at
module import: the CPU tests import every module of the port.

Every C entry point has one signature,

    int mt_<name>(void* const* ptrs, int n_ptrs,
                  const long long* ints, int n_ints, void* stream)

taking the tensors' device pointers and the integer arguments in the order
its source documents, and returns `cudaGetLastError()` after the launch
(or `cudaErrorInvalidValue` for a wrong argument count).

Dispatch rule for every wrapper (`use_kernel`): tensors on the CPU take the
plain PyTorch version; tensors on a CUDA device launch the kernel or raise.
`forced_plain()` runs the plain versions on the card too, so a caller can
hold a whole run through the kernels against one through the plain
versions; nothing on the main path enters it."""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name            # C symbol is mt_<name>
        self.source = source        # path in the repo
        self.replaces = replaces    # file:line of the JAX function
        self.launches = 0

    def launch(self, tensors, ints, device, strided=()) -> None:
        """`strided`: those of `tensors` that the kernel indexes through
        strides passed among `ints`; every other tensor must be
        contiguous. A None entry passes a null pointer (an optional
        plane the kernel skips)."""
        for t in tensors:
            if t is None:
                continue
            if t.device != device:
                raise ValueError(f"{self.name}: tensor on {t.device}, "
                                 f"expected {device}")
            if not (t.is_contiguous() or any(t is s for s in strided)):
                raise ValueError(f"{self.name}: non-contiguous tensor")
        fn = getattr(_library(), f"mt_{self.name}")
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if t is None else t.data_ptr() for t in tensors])
        vals = (ctypes.c_longlong * len(ints))(*[int(i) for i in ints])
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = fn(ptrs, len(tensors), vals, len(ints),
                     ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"kernel {self.name} failed to launch: "
                               f"CUDA error {err}")
        self.launches += 1


EDGE_READ = Kernel("edge_read", "maelstrom_tpu_torch/csrc/edge.cu",
                   "maelstrom_tpu/net/static.py:325")
EDGE_WRITE = Kernel("edge_write", "maelstrom_tpu_torch/csrc/edge.cu",
                    "maelstrom_tpu/net/static.py:168")
BROADCAST_STEP = Kernel("broadcast_step",
                        "maelstrom_tpu_torch/csrc/broadcast.cu",
                        "maelstrom_tpu/nodes/broadcast.py:205")
REPLY_COMPACT = Kernel("reply_compact", "maelstrom_tpu_torch/csrc/compact.cu",
                       "maelstrom_tpu/sim.py:496")
REPLY_LOG_APPEND = Kernel("reply_log_append",
                          "maelstrom_tpu_torch/csrc/scan.cu",
                          "maelstrom_tpu/sim.py:821")
QUIET_PROBE = Kernel("quiet_probe", "maelstrom_tpu_torch/csrc/scan.cu",
                     "maelstrom_tpu/runner/tpu_runner.py:2048")
THREEFRY = Kernel("threefry", "maelstrom_tpu_torch/csrc/prng.cu",
                  "maelstrom_tpu/net/tpu.py:238")
EDGE_FAULTS = Kernel("edge_faults", "maelstrom_tpu_torch/csrc/faults.cu",
                     "maelstrom_tpu/sim.py:545")
EDGE_WRITE_SPILL = Kernel("edge_write_spill",
                          "maelstrom_tpu_torch/csrc/edge.cu",
                          "maelstrom_tpu/net/static.py:267")
BROADCAST_STEP_STALL = Kernel("broadcast_step_stall",
                              "maelstrom_tpu_torch/csrc/broadcast.cu",
                              "maelstrom_tpu/sim.py:94")
RAFT_STEP = Kernel("raft_step", "maelstrom_tpu_torch/csrc/raft.cu",
                   "maelstrom_tpu/nodes/raft.py:220")
ECHO_STEP = Kernel("echo_step", "maelstrom_tpu_torch/csrc/pool.cu",
                   "maelstrom_tpu/nodes/echo.py:28")
UNIQUE_IDS_STEP = Kernel("unique_ids_step", "maelstrom_tpu_torch/csrc/pool.cu",
                         "maelstrom_tpu/nodes/unique_ids.py:30")
PN_COUNTER_STEP = Kernel("pn_counter_step",
                         "maelstrom_tpu_torch/csrc/pn_counter.cu",
                         "maelstrom_tpu/nodes/pn_counter.py:87")
REPLY_LOG_APPEND_I32 = Kernel("reply_log_append_i32",
                              "maelstrom_tpu_torch/csrc/scan.cu",
                              "maelstrom_tpu/nodes/pn_counter.py:211")
KAFKA_STEP = Kernel("kafka_step", "maelstrom_tpu_torch/csrc/kafka.cu",
                    "maelstrom_tpu/nodes/kafka.py:246")
BROADCAST_BATCHED_STEP = Kernel(
    "broadcast_batched_step", "maelstrom_tpu_torch/csrc/broadcast_batched.cu",
    "maelstrom_tpu/nodes/broadcast_batched.py:140")
BROADCAST_BATCHED_STEP_STALL = Kernel(
    "broadcast_batched_step_stall",
    "maelstrom_tpu_torch/csrc/broadcast_batched.cu",
    "maelstrom_tpu/sim.py:94")
ELLE_EDGES = Kernel("elle_edges", "maelstrom_tpu_torch/csrc/elle.cu",
                    "maelstrom_tpu/checkers/elle_device.py:217")
ELLE_SCREEN = Kernel("elle_screen", "maelstrom_tpu_torch/csrc/elle.cu",
                     "maelstrom_tpu/checkers/elle_device.py:221")
SCHED_INJECT = Kernel("sched_inject", "maelstrom_tpu_torch/csrc/stream.cu",
                      "maelstrom_tpu/sim.py:847")
RING_UPDATE = Kernel("ring_update", "maelstrom_tpu_torch/csrc/telemetry.cu",
                     "maelstrom_tpu/telemetry.py:130")
TSO_STEP = Kernel("tso_step", "maelstrom_tpu_torch/csrc/services.cu",
                  "maelstrom_tpu/nodes/services.py:106")
SEQ_KV_STEP = Kernel("seq_kv_step", "maelstrom_tpu_torch/csrc/services.cu",
                     "maelstrom_tpu/nodes/services.py:138")
LWW_KV_STEP = Kernel("lww_kv_step", "maelstrom_tpu_torch/csrc/services.cu",
                     "maelstrom_tpu/nodes/services.py:199")
COMPARTMENT_SEQUENCER_STEP = Kernel(
    "compartment_sequencer_step", "maelstrom_tpu_torch/csrc/compartment.cu",
    "maelstrom_tpu/nodes/compartment.py:465")
COMPARTMENT_PROXY_STEP = Kernel(
    "compartment_proxy_step", "maelstrom_tpu_torch/csrc/compartment.cu",
    "maelstrom_tpu/nodes/compartment.py:877")
COMPARTMENT_ACCEPTOR_STEP = Kernel(
    "compartment_acceptor_step", "maelstrom_tpu_torch/csrc/compartment.cu",
    "maelstrom_tpu/nodes/compartment.py:1095")
COMPARTMENT_REPLICA_STEP = Kernel(
    "compartment_replica_step", "maelstrom_tpu_torch/csrc/compartment.cu",
    "maelstrom_tpu/nodes/compartment.py:1238")
COMPARTMENT_SEQUENCER_ELECT = Kernel(
    "compartment_sequencer_elect", "maelstrom_tpu_torch/csrc/compartment.cu",
    "maelstrom_tpu/nodes/compartment.py:524")
COMPARTMENT_PROXY_ELECT = Kernel(
    "compartment_proxy_elect", "maelstrom_tpu_torch/csrc/compartment.cu",
    "maelstrom_tpu/nodes/compartment.py:877")
COMPARTMENT_ACCEPTOR_ELECT = Kernel(
    "compartment_acceptor_elect", "maelstrom_tpu_torch/csrc/compartment.cu",
    "maelstrom_tpu/nodes/compartment.py:1115")
BYZ_CORRUPT_POOL = Kernel("byz_corrupt_pool",
                          "maelstrom_tpu_torch/csrc/byzantine.cu",
                          "maelstrom_tpu/byzantine.py:163")
BYZ_CORRUPT_EDGE = Kernel("byz_corrupt_edge",
                          "maelstrom_tpu_torch/csrc/byzantine.cu",
                          "maelstrom_tpu/byzantine.py:178")
FLEET_HOLD = Kernel("fleet_hold", "maelstrom_tpu_torch/csrc/fleet.cu",
                    "maelstrom_tpu/sim.py:1002")
WAVE_REDUCE = Kernel("wave_reduce", "maelstrom_tpu_torch/csrc/fleet.cu",
                     "maelstrom_tpu/runner/sessions.py:61")
REPLY_LOG_FLEET = Kernel("reply_log_fleet",
                         "maelstrom_tpu_torch/csrc/fleet.cu",
                         "maelstrom_tpu/sim.py:999")
QUIET_PROBE_FLEET = Kernel("quiet_probe_fleet",
                           "maelstrom_tpu_torch/csrc/fleet.cu",
                           "maelstrom_tpu/runner/fleet_runner.py:403")
KERNELS = (EDGE_READ, EDGE_WRITE, BROADCAST_STEP, REPLY_COMPACT,
           REPLY_LOG_APPEND, QUIET_PROBE, THREEFRY, EDGE_FAULTS,
           EDGE_WRITE_SPILL, BROADCAST_STEP_STALL, RAFT_STEP, ECHO_STEP,
           UNIQUE_IDS_STEP, PN_COUNTER_STEP, REPLY_LOG_APPEND_I32,
           KAFKA_STEP, BROADCAST_BATCHED_STEP, BROADCAST_BATCHED_STEP_STALL,
           ELLE_EDGES, ELLE_SCREEN, SCHED_INJECT, RING_UPDATE, TSO_STEP,
           SEQ_KV_STEP, LWW_KV_STEP, COMPARTMENT_SEQUENCER_STEP,
           COMPARTMENT_PROXY_STEP, COMPARTMENT_ACCEPTOR_STEP,
           COMPARTMENT_REPLICA_STEP, COMPARTMENT_SEQUENCER_ELECT,
           COMPARTMENT_PROXY_ELECT, COMPARTMENT_ACCEPTOR_ELECT,
           BYZ_CORRUPT_POOL, BYZ_CORRUPT_EDGE, FLEET_HOLD, WAVE_REDUCE,
           REPLY_LOG_FLEET, QUIET_PROBE_FLEET)

_state = {"lib": None, "forced_plain": False}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


@contextlib.contextmanager
def forced_plain():
    """Inside this block CUDA tensors take the plain versions too."""
    prev = _state["forced_plain"]
    _state["forced_plain"] = True
    try:
        yield
    finally:
        _state["forced_plain"] = prev


def use_kernel(t: torch.Tensor) -> bool:
    """True when `t` must go through the kernel, False for the plain
    version (CPU tensors, or inside `forced_plain`)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return not _state["forced_plain"]


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return nvcc


def build(verbose: bool = False) -> Path:
    """Compiles every source (one nvcc each, in parallel) and links the
    library, unless the library for these sources exists. Returns its
    path."""
    BUILD.mkdir(exist_ok=True)
    lib = BUILD / f"libmt_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        def compile_one(src: Path) -> Path:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   f"{res.stdout}{res.stderr}")
            if verbose and res.stderr:
                print(res.stderr, file=sys.stderr, flush=True)
            return obj

        srcs = sorted(CSRC.glob("*.cu"))
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            objs = list(pool.map(compile_one, srcs))
        part = Path(tmp) / lib.name
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(part),
                              *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(part, lib)
    return lib


def _library():
    if _state["lib"] is None:
        lib = ctypes.CDLL(str(build()))
        for k in KERNELS:
            fn = getattr(lib, f"mt_{k.name}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _state["lib"] = lib
    return _state["lib"]
