"""Binary laser-log codec: ctypes binding of the native C++ library with a
byte-identical NumPy fallback.

The ``FSLG1`` format (see native/logcodec.cpp for the layout) gives O(1)
random access into fixed-size tick records — the data-loader path for
high-rate replay and multi-epoch benchmarking, where parsing npz/JSON per
run would dominate.  The shared library is not checked in: it is built from
native/logcodec.cpp on first use (``make -C native``, under a file lock so
concurrent processes build it once); if no toolchain is available the NumPy
codec reads/writes the identical bytes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HEADER_BYTES = 64
_MAGIC = b"FSLG1"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfslogcodec.so")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native codec; None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not os.path.exists(_LIB_PATH) and os.path.isdir(_NATIVE_DIR):
            import fcntl

            with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(_LIB_PATH):
                    subprocess.run(
                        ["make", "-C", _NATIVE_DIR, "-s"],
                        check=True, capture_output=True, timeout=120,
                    )
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return None

    u32 = ctypes.c_uint32
    lib.fslog_write.restype = ctypes.c_int
    lib.fslog_write.argtypes = [
        ctypes.c_char_p, u32, u32, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.fslog_read_header.restype = ctypes.c_int
    lib.fslog_read_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(u32), ctypes.POINTER(u32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.fslog_read.restype = ctypes.c_int
    lib.fslog_read.argtypes = [
        ctypes.c_char_p, u32, u32,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_library() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------

def write_log(path: str, log, *, force_numpy: bool = False) -> str:
    """Write a LaserLog in FSLG1 format.  Returns 'native' or 'numpy'."""
    t = len(log)
    b = log.scans.shape[1]
    timestamps = np.ascontiguousarray(log.timestamps, np.float64)
    cmd_v = np.ascontiguousarray(log.cmd_v, np.float32)
    cmd_w = np.ascontiguousarray(log.cmd_w, np.float32)
    bst = np.ascontiguousarray(log.bumper_state, np.int32)
    bid = np.ascontiguousarray(log.bumper_id, np.int32)
    gt = np.ascontiguousarray(log.gt_poses, np.float64)
    scans = np.ascontiguousarray(log.scans, np.float32)

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)

    lib = None if force_numpy else _load_library()
    if lib is not None:
        rc = lib.fslog_write(
            path.encode(), t, b,
            ctypes.c_float(log.min_range), ctypes.c_float(log.max_range),
            _ptr(timestamps, ctypes.c_double), _ptr(cmd_v, ctypes.c_float),
            _ptr(cmd_w, ctypes.c_float), _ptr(bst, ctypes.c_int32),
            _ptr(bid, ctypes.c_int32), _ptr(gt, ctypes.c_double),
            _ptr(scans, ctypes.c_float),
        )
        if rc != 0:
            raise OSError(f"fslog_write failed: {rc}")
        return "native"

    # NumPy fallback — identical bytes
    header = bytearray(_HEADER_BYTES)
    header[:5] = _MAGIC
    rec_bytes = 8 + 4 + 4 + 4 + 24 + 4 * b
    header[8:12] = np.uint32(t).tobytes()
    header[12:16] = np.uint32(b).tobytes()
    header[16:20] = np.float32(log.min_range).tobytes()
    header[20:24] = np.float32(log.max_range).tobytes()
    header[24:28] = np.uint32(rec_bytes).tobytes()

    rec = np.zeros(t, dtype=_record_dtype(b))
    rec["timestamp"] = timestamps
    rec["cmd_v"] = cmd_v
    rec["cmd_w"] = cmd_w
    rec["bumper"] = (bst.astype(np.uint32) & 0xFF) | (
        (bid.astype(np.uint32) & 0xFF) << 8
    )
    rec["gt"] = gt
    rec["scan"] = scans
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())
    return "numpy"


def _record_dtype(num_beams: int) -> np.dtype:
    return np.dtype([
        ("timestamp", "<f8"),
        ("cmd_v", "<f4"),
        ("cmd_w", "<f4"),
        ("bumper", "<u4"),
        ("gt", "<f8", (3,)),
        ("scan", "<f4", (num_beams,)),
    ])


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------

def read_log(path: str, *, start: int = 0, count: Optional[int] = None,
             force_numpy: bool = False, mmap: bool = False):
    """Read a LaserLog (optionally a tick slice) from FSLG1.

    With ``mmap=True`` the record block is memory-mapped read-only instead of
    copied — O(1) open time and no RSS spike for multi-GB logs; pages fault
    in as the replay touches them.  (Scans stay a zero-copy strided view;
    small per-tick columns are materialized since they are read densely.)
    """
    from fastslam_tpu.drivers.replay import LaserLog

    if start < 0 or (count is not None and count < 0):
        raise ValueError("start/count must be non-negative")
    if mmap:
        return _read_log_mmap(path, start, count)
    lib = None if force_numpy else _load_library()
    if lib is not None:
        u32 = ctypes.c_uint32
        nt, nb = u32(), u32()
        mn, mx = ctypes.c_float(), ctypes.c_float()
        rc = lib.fslog_read_header(
            path.encode(), ctypes.byref(nt), ctypes.byref(nb),
            ctypes.byref(mn), ctypes.byref(mx),
        )
        if rc != 0:
            raise OSError(f"fslog_read_header failed: {rc}")
        t_total, b = nt.value, nb.value
        n = t_total - start if count is None else count
        if n < 0 or start + n > t_total:
            raise OSError(
                f"slice [{start}, {start}+{n}) out of range for {t_total} ticks"
            )
        # a corrupt header may claim far more ticks than the file holds —
        # validate against the on-disk size BEFORE allocating output buffers
        rec_bytes = 8 + 4 + 4 + 4 + 24 + 4 * b
        if _HEADER_BYTES + t_total * rec_bytes > os.path.getsize(path):
            raise OSError("truncated FSLG1 file (header claims more ticks)")

        timestamps = np.empty(n, np.float64)
        cmd_v = np.empty(n, np.float32)
        cmd_w = np.empty(n, np.float32)
        bst = np.empty(n, np.int32)
        bid = np.empty(n, np.int32)
        gt = np.empty((n, 3), np.float64)
        scans = np.empty((n, b), np.float32)
        rc = lib.fslog_read(
            path.encode(), start, n,
            _ptr(timestamps, ctypes.c_double), _ptr(cmd_v, ctypes.c_float),
            _ptr(cmd_w, ctypes.c_float), _ptr(bst, ctypes.c_int32),
            _ptr(bid, ctypes.c_int32), _ptr(gt, ctypes.c_double),
            _ptr(scans, ctypes.c_float),
        )
        if rc != 0:
            raise OSError(f"fslog_read failed: {rc}")
        return LaserLog(
            scans=scans, min_range=float(mn.value), max_range=float(mx.value),
            timestamps=timestamps, cmd_v=cmd_v, cmd_w=cmd_w,
            bumper_state=bst, bumper_id=bid, gt_poses=gt,
        )

    # NumPy fallback — same validation the C++ reader performs
    with open(path, "rb") as f:
        header = f.read(_HEADER_BYTES)
        if len(header) < _HEADER_BYTES or header[:5] != _MAGIC:
            raise OSError("not an FSLG1 file")
        t_total = int(np.frombuffer(header[8:12], "<u4")[0])
        b = int(np.frombuffer(header[12:16], "<u4")[0])
        mn = float(np.frombuffer(header[16:20], "<f4")[0])
        mx = float(np.frombuffer(header[20:24], "<f4")[0])
        rec_bytes = int(np.frombuffer(header[24:28], "<u4")[0])
        if b == 0 or b > 1_000_000 or rec_bytes != 8 + 4 + 4 + 4 + 24 + 4 * b:
            raise OSError("corrupt FSLG1 header: record size mismatch")
        dt = _record_dtype(b)
        n = t_total - start if count is None else count
        if n < 0 or start + n > t_total:
            raise OSError(
                f"slice [{start}, {start}+{n}) out of range for {t_total} ticks"
            )
        if _HEADER_BYTES + t_total * dt.itemsize > os.path.getsize(path):
            raise OSError("truncated FSLG1 file (header claims more ticks)")
        f.seek(_HEADER_BYTES + start * dt.itemsize)
        data = f.read(n * dt.itemsize)
        if len(data) != n * dt.itemsize:
            raise OSError("truncated FSLG1 file")
        rec = np.frombuffer(data, dtype=dt)

    return LaserLog(
        scans=np.ascontiguousarray(rec["scan"]),
        min_range=mn, max_range=mx,
        timestamps=np.ascontiguousarray(rec["timestamp"]),
        cmd_v=np.ascontiguousarray(rec["cmd_v"]),
        cmd_w=np.ascontiguousarray(rec["cmd_w"]),
        bumper_state=(rec["bumper"] & 0xFF).astype(np.int32),
        bumper_id=((rec["bumper"] >> 8) & 0xFF).astype(np.int32),
        gt_poses=np.ascontiguousarray(rec["gt"]),
    )


def _read_log_mmap(path: str, start: int, count: Optional[int]):
    """Memory-mapped read: the scan block is a zero-copy strided view into
    the page cache; small per-tick columns are materialized."""
    from fastslam_tpu.drivers.replay import LaserLog

    with open(path, "rb") as f:
        header = f.read(_HEADER_BYTES)
    if len(header) < _HEADER_BYTES or header[:5] != _MAGIC:
        raise OSError("not an FSLG1 file")
    t_total = int(np.frombuffer(header[8:12], "<u4")[0])
    b = int(np.frombuffer(header[12:16], "<u4")[0])
    mn = float(np.frombuffer(header[16:20], "<f4")[0])
    mx = float(np.frombuffer(header[20:24], "<f4")[0])
    rec_bytes = int(np.frombuffer(header[24:28], "<u4")[0])
    if b == 0 or b > 1_000_000 or rec_bytes != 8 + 4 + 4 + 4 + 24 + 4 * b:
        raise OSError("corrupt FSLG1 header: record size mismatch")
    dt = _record_dtype(b)
    n = t_total - start if count is None else count
    if n < 0 or start + n > t_total:
        raise OSError(
            f"slice [{start}, {start}+{n}) out of range for {t_total} ticks"
        )
    if _HEADER_BYTES + t_total * dt.itemsize > os.path.getsize(path):
        raise OSError("truncated FSLG1 file (header claims more ticks)")

    rec = np.memmap(path, dtype=dt, mode="r", offset=_HEADER_BYTES,
                    shape=(t_total,))[start:start + n]
    bumper = np.asarray(rec["bumper"])
    return LaserLog(
        scans=rec["scan"],  # zero-copy strided view over the mapping
        min_range=mn, max_range=mx,
        timestamps=np.asarray(rec["timestamp"]),
        cmd_v=np.asarray(rec["cmd_v"]),
        cmd_w=np.asarray(rec["cmd_w"]),
        bumper_state=(bumper & 0xFF).astype(np.int32),
        bumper_id=((bumper >> 8) & 0xFF).astype(np.int32),
        gt_poses=np.asarray(rec["gt"]),
    )
