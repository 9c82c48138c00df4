"""ctypes bindings for the port's native (C++) host-path libraries
(counterpart of mmd_tpu/native/bindings.py).

Three libraries, the port's own copies of the JAX package's sources:
  * tokenizer.cpp  the WordPiece batch encoder (data/tokenizer.py's
                   `encode_batch` on ASCII, pair-free batches);
  * spm.cpp        the SentencePiece-unigram Viterbi batch encoder and the
                   precompiled-charsmap normalizer (data/spm.py);
  * gather.cpp     the threaded row gather of ArrayStore.batches
                   (data/store.py) for columns of at least
                   NATIVE_GATHER_MIN_BYTES a batch; it writes each row to
                   its batch position, where the JAX package's copy
                   reorders the sorted rows in numpy.

Each is built with the host's C++ compiler (`$CXX`, else g++, else c++) at
first use into `build/mmd_tpu_torch/native/` at the root of the checkout,
named by a hash of its source, the flags, the compiler and its version and
the machine, so an edited source or another toolchain never loads a stale
build. A process builds a library once (a lock per library); processes
that build at once serialize on a lock file beside it, and the library
appears by an atomic rename, so a loader sees all of it or nothing.
Nothing is committed as a shared object.

Every caller keeps its Python path, as in the JAX package: for non-ASCII
WordPiece text, pair batches, a text holding NUL, and a machine without a
compiler (a failed build is recorded in `build_errors` and the library
reads as absent). MMD_NATIVE=0 in the environment forces the Python paths.
A call starts threads in proportion to its work, at most MAX_THREADS
(`threads_for`); `python -m mmd_tpu_torch.native.measure` times each
library against its Python or numpy path at several sizes and thread
counts. Each binding counts its calls (`calls`), so a run can show which
path it took.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mmd_tpu_torch" \
    / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
SOURCES = {"tok": "tokenizer.cpp", "spm": "spm.cpp", "gather": "gather.cpp"}
# A call of the WordPiece encoder starts a thread for each
# TOKENIZER_BYTES_PER_THREAD of text and the row gather one for each
# GATHER_BYTES_PER_THREAD of output, at most MAX_THREADS. Read off
# `python -m mmd_tpu_torch.native.measure` on an H100 machine's 8-CPU host
# (PERF.md section 5): each thread started there cost ~0.1-0.2 ms, so 8
# threads lost to 4 at every size measured (up to 100 MB of gather and
# 300 KB of text) and to 1 on small calls; the encoder gained from a
# second thread at 23 KB of text (not at 1 KB) and from four at 300 KB;
# the gather from two to four threads from 3 MB on, and ran one thread
# best at 1 MB.
TOKENIZER_BYTES_PER_THREAD = 8 * 1024
GATHER_BYTES_PER_THREAD = 2 ** 20
MAX_THREADS = 4

_I32P = ctypes.POINTER(ctypes.c_int32)

# Calls of each binding in this process; a run resets them to 0 and reads
# them back to show that its host path went through the native code.
calls = {"tokenizer": 0, "spm": 0, "charsmap": 0, "gather": 0}
_calls_lock = threading.Lock()
# library -> the compiler's message of a failed build in this process
build_errors: dict[str, str] = {}

_lock = threading.Lock()
_lib_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, Optional[ctypes.CDLL]] = {}


def _count(name: str) -> None:
    with _calls_lock:
        calls[name] += 1


def cpus() -> int:
    """CPUs this process may run on (its affinity mask, not the host's)."""
    return len(os.sched_getaffinity(0))


def threads_for(work_bytes: int, bytes_per_thread: int) -> int:
    """Threads for a call of `work_bytes`: one per `bytes_per_thread`, at
    most min(MAX_THREADS, CPUs). The JAX package's bindings start
    min(16, CPUs) on every call."""
    return max(1, min(MAX_THREADS, cpus(), work_bytes // bytes_per_thread))


def enabled() -> bool:
    return os.environ.get("MMD_NATIVE", "1") != "0"


def find_cxx() -> Optional[str]:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def _toolchain(cxx: str) -> str:
    res = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    first = res.stdout.splitlines()[0] if res.stdout else ""
    return f"{cxx} {first} {platform.machine()}"


def library_path(name: str, cxx: str) -> Path:
    """Where library `name` ("tok", "spm", "gather") built by `cxx` lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(_toolchain(cxx).encode())
    digest.update((SRC / SOURCES[name]).read_bytes())
    return BUILD_DIR / f"libmmd{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library `name` if its build does not exist yet; returns its
    path. Raises when there is no compiler or the compile fails."""
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, g++ or c++) on PATH")
    out = library_path(name, cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # another process's build
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC / SOURCES[name])]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed with exit code "
                               f"{res.returncode}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    return out


def load(name: str) -> Optional[ctypes.CDLL]:
    """Library `name`, built at first use; None when native code is
    disabled or cannot be built or loaded here (callers take their Python
    path)."""
    if not enabled():
        return None
    with _lock:
        lib_lock = _lib_locks.setdefault(name, threading.Lock())
    with lib_lock:
        if name not in _loaded:
            try:
                _loaded[name] = ctypes.CDLL(str(build(name)))
            except (OSError, RuntimeError) as e:
                build_errors[name] = str(e)
                _loaded[name] = None
        return _loaded[name]


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

def _payload(texts: Sequence[str]) -> bytes:
    """The batch as the encoders read it: NUL-separated UTF-8."""
    return b"\x00".join(str(t).encode("utf-8") for t in texts) + b"\x00"


class NativeTokenizer:
    """Batch WordPiece encoder backed by tokenizer.cpp.

    Exact parity with the Python encoder for ASCII text; callers route
    non-ASCII batches through the Python path (data/tokenizer.py's dispatch
    does this)."""

    def __init__(self, vocab: Sequence[str]):
        lib = load("tok")
        if lib is None:
            raise RuntimeError(f"the native tokenizer is unavailable: "
                               f"{build_errors.get('tok', 'disabled')}")
        lib.mmdtok_create.restype = ctypes.c_void_p
        lib.mmdtok_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32]
        lib.mmdtok_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, _I32P, _I32P, ctypes.c_int32]
        lib.mmdtok_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        ids = {t: i for i, t in enumerate(vocab)}
        blob = "\n".join(vocab).encode("utf-8")
        self._handle = lib.mmdtok_create(
            blob, len(blob), ids["[PAD]"], ids["[UNK]"], ids["[CLS]"],
            ids["[SEP]"])
        if not self._handle:
            raise RuntimeError("mmdtok_create failed")

    def encode_batch(self, texts: Sequence[str], max_length: int):
        payload = _payload(texts)
        return self._encode(payload, len(texts), max_length, threads_for(
            len(payload), TOKENIZER_BYTES_PER_THREAD))

    def _encode(self, payload: bytes, n: int, max_length: int,
                threads: int):
        ids = np.empty((n, max_length), np.int32)
        mask = np.empty((n, max_length), np.int32)
        self._lib.mmdtok_encode_batch(
            self._handle, payload, len(payload), n, max_length,
            ids.ctypes.data_as(_I32P), mask.ctypes.data_as(_I32P), threads)
        _count("tokenizer")
        types = np.zeros((n, max_length), np.int32)
        return ids, mask, types

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.mmdtok_destroy(self._handle)
        except Exception:          # ctypes torn down at interpreter exit
            pass


# ---------------------------------------------------------------------------
# SentencePiece-unigram (Viterbi) encoder + charsmap normalizer
# ---------------------------------------------------------------------------

class NativeSpm:
    """Batch SPM-unigram encoder backed by spm.cpp.

    Exact parity with data/spm.py::UnigramTokenizer for pair-free batches:
    the caller normalizes and metaspaces each text in Python, this runs
    the byte-trie Viterbi, unknown fusing, and the [CLS]/[SEP]/pad layout
    in C++."""

    def __init__(self, pieces, unk_id: int, pad_id: int, cls_id: int,
                 sep_id: int, unk_score: float):
        lib = load("spm")
        if lib is None:
            raise RuntimeError(f"the native unigram encoder is unavailable: "
                               f"{build_errors.get('spm', 'disabled')}")
        lib.mmdspm_create.restype = ctypes.c_void_p
        lib.mmdspm_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), _I32P,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double]
        lib.mmdspm_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, _I32P, _I32P, _I32P]
        lib.mmdspm_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        blob = b"\x00".join(p.encode("utf-8") for p, _, _ in pieces) + b"\x00"
        scores = np.ascontiguousarray([s for _, s, _ in pieces], np.float64)
        types = np.ascontiguousarray([t for _, _, t in pieces], np.int32)
        self._handle = lib.mmdspm_create(
            blob, len(blob), scores.ctypes.data_as(
                ctypes.POINTER(ctypes.c_double)),
            types.ctypes.data_as(_I32P), len(pieces),
            unk_id, pad_id, cls_id, sep_id, unk_score)
        if not self._handle:
            raise RuntimeError("mmdspm_create failed")

    def encode_batch(self, prepared_texts: Sequence[str], max_length: int):
        """prepared_texts: already normalized + metaspace'd ("" = empty)."""
        n = len(prepared_texts)
        payload = _payload(prepared_texts)
        ids = np.empty((n, max_length), np.int32)
        mask = np.empty((n, max_length), np.int32)
        types = np.empty((n, max_length), np.int32)
        self._lib.mmdspm_encode_batch(
            self._handle, payload, len(payload), n, max_length,
            ids.ctypes.data_as(_I32P), mask.ctypes.data_as(_I32P),
            types.ctypes.data_as(_I32P))
        _count("spm")
        return ids, mask, types

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.mmdspm_destroy(self._handle)
        except Exception:          # ctypes torn down at interpreter exit
            pass


def _spm_lib() -> Optional[ctypes.CDLL]:
    lib = load("spm")
    if lib is not None and lib.mmdspm_charsmap_normalize.argtypes is None:
        lib.mmdspm_charsmap_normalize.restype = ctypes.c_int64
        lib.mmdspm_charsmap_normalize.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    return lib


def charsmap_normalize(blob: bytes, text: str) -> Optional[str]:
    """Native precompiled-charsmap normalization; None when the library is
    unavailable or the blob is corrupt (the caller takes the Python byte
    loop)."""
    lib = _spm_lib()
    if lib is None:
        return None
    data = text.encode("utf-8")
    cap = max(64, 4 * len(data))
    while True:
        out = ctypes.create_string_buffer(cap)
        n = lib.mmdspm_charsmap_normalize(blob, len(blob), data, len(data),
                                          out, cap)
        if n == -1:
            cap *= 2
            continue
        if n < 0:
            return None
        _count("charsmap")
        return out.raw[:n].decode("utf-8")


# ---------------------------------------------------------------------------
# Row gather
# ---------------------------------------------------------------------------

def gather_rows(src: np.ndarray, indices: np.ndarray,
                dest: np.ndarray) -> Optional[np.ndarray]:
    """out[dest[i]] = src[indices[i]], `dest` a permutation of
    range(len(indices)), for a C-contiguous array of one or more
    dimensions (memmap-friendly): sorted `indices` read the source in file
    order and `dest` puts each row in its batch position in the same copy.
    None when the library is unavailable or src is not C-contiguous (the
    caller gathers with numpy)."""
    lib = _gather_lib()
    if lib is None or not src.flags["C_CONTIGUOUS"]:
        return None
    return _gather(lib, src, indices, dest, threads_for(
        len(indices) * row_bytes(src), GATHER_BYTES_PER_THREAD))


def row_bytes(src: np.ndarray) -> int:
    """Bytes of one row of an array."""
    return src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))


def _gather_lib() -> Optional[ctypes.CDLL]:
    lib = load("gather")
    if lib is not None and lib.mmdgather_rows.argtypes is None:
        lib.mmdgather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32]
    return lib


def _gather(lib: ctypes.CDLL, src: np.ndarray, indices, dest,
            threads: int) -> np.ndarray:
    idx = np.ascontiguousarray(indices, np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"row indices out of range for {len(src)} rows")
    dst = np.ascontiguousarray(dest, np.int64)
    if not np.array_equal(np.sort(dst), np.arange(len(idx))):
        raise IndexError("dest is not a permutation of the batch rows")
    out = np.empty((len(idx), *src.shape[1:]), src.dtype)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mmdgather_rows(ctypes.c_void_p(src.ctypes.data), row_bytes(src),
                       idx.ctypes.data_as(i64p), dst.ctypes.data_as(i64p),
                       len(idx), ctypes.c_void_p(out.ctypes.data), threads)
    _count("gather")
    return out
