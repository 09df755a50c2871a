"""A hand-written codec for the msgpack that the JAX package's checkpoints
hold, so the port reads and writes them without ``flax`` or ``msgpack``.

The JAX package writes ``flax.serialization.msgpack_serialize(payload)``:
plain msgpack (nil, bool, int, float, str, bin, array, map) with numpy
arrays as extension type 1, whose data is the msgpack array ``[shape, dtype
name, C-order bytes]``, and numpy scalars as extension type 3 (the same
data, a 0-d array). ``packb`` writes the same bytes as flax for the same
payload, including flax's order of map keys: it copies the payload with
``jax.tree_util.tree_map``, which sorts dict keys, so ``packb`` sorts them
too. flax splits an array above 1 GiB into chunks only when it is a dict
value; the checkpoints hold every array in a list, so no chunked form
appears, and an array of 4 GiB or more (the limit of msgpack's bin32)
raises.

Leaves that ``packb``/``dump`` take: ``np.ndarray``, numpy scalars, and
torch tensors, ``torch.bfloat16`` ones written under the dtype name
``bfloat16`` as the JAX package's are; a CUDA tensor's bytes stream to the
file through pinned staging buffers (``_DeviceCopier``). ``unpackb``/``load`` return
lists, dicts, Python scalars and read-only numpy arrays that view the
encoded buffer (no copy of the payload); a ``bfloat16`` array comes back as
a ``torch.bfloat16`` tensor (numpy has no such dtype) over an int16 view of
the buffer. An unknown extension code or dtype raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3

# numpy dtypes a checkpoint leaf may have (the bfloat16 name is handled apart)
_DTYPES = {np.dtype(n).name: np.dtype(n) for n in (
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64")}
_TORCH_TO_NUMPY = {torch.bool: np.bool_, torch.int8: np.int8, torch.int16: np.int16,
                   torch.int32: np.int32, torch.int64: np.int64, torch.uint8: np.uint8,
                   torch.float16: np.float16, torch.float32: np.float32,
                   torch.float64: np.float64}
_MAX32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _int(n: int) -> bytes:
    """msgpack-python's choice of int format (smallest that holds n)."""
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return b"\xcc" + struct.pack("B", n)
    if -0x80 <= n < 0:
        return b"\xd0" + struct.pack("b", n)
    if 0xFF < n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if -0x8000 <= n < -0x80:
        return b"\xd1" + struct.pack(">h", n)
    if 0xFFFF < n <= _MAX32:
        return b"\xce" + struct.pack(">I", n)
    if -0x80000000 <= n < -0x8000:
        return b"\xd2" + struct.pack(">i", n)
    if _MAX32 < n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    if -0x8000000000000000 <= n < -0x80000000:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, codes: tuple[int, int, int],
           what: str) -> bytes:
    """Header of a str/bin/array/map of length n: a fix form up to
    ``fix_max``, then 8-, 16- and 32-bit lengths (``codes``; a code of 0 is
    a width the type lacks)."""
    if fix is not None and n <= fix_max:
        return struct.pack("B", fix | n)
    for code, fmt, top in zip(codes, ("B", ">H", ">I"), (0xFF, 0xFFFF, _MAX32)):
        if code and n <= top:
            return struct.pack("B", code) + struct.pack(fmt, n)
    raise ValueError(f"{what} of {n} bytes or items is beyond msgpack's 32-bit lengths")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _sized(len(data), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB), "str") + data


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return struct.pack("Bb", fixed[n], code)
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9), "ext") + struct.pack("b", code)


def _array_head(shape, dtype_name: str, nbytes: int) -> bytes:
    """The ext payload ``[shape, dtype name, bytes]`` up to the data."""
    return (b"\x93" + _sized(len(shape), 0x90, 0x0F, (0, 0xDC, 0xDD), "array")
            + b"".join(_int(int(d)) for d in shape) + _str(dtype_name)
            + _sized(nbytes, None, 0, (0xC4, 0xC5, 0xC6), "bin"))


class _DeviceCopier:
    """Streams CUDA tensors' bytes to the host through two pinned staging
    buffers, on a stream of its own: the copy of one chunk overlaps the
    write of the previous one, no host copy of the whole payload is made,
    and the copies are DMA transfers that leave other threads' launches
    alone (a copy into pageable memory stalls them). The stream first waits
    for ``ready`` (a CUDA event behind the tensors' producers), or else for
    the caller's current stream."""

    CHUNK = 16 << 20

    def __init__(self, device: torch.device, ready=None):
        self.stream = torch.cuda.Stream(device)
        if ready is not None:
            self.stream.wait_event(ready)
        else:
            self.stream.wait_stream(torch.cuda.current_stream(device))
        self.bufs = [torch.empty(self.CHUNK, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]

    def pieces(self, t: torch.Tensor) -> Iterator[memoryview]:
        """The C-order bytes of ``t``, chunk by chunk; each piece is valid
        until the next is asked for."""
        with torch.cuda.stream(self.stream):
            data = t.detach().contiguous().view(-1).view(torch.uint8)
        pending = None
        for k, start in enumerate(range(0, data.numel(), self.CHUNK)):
            i = k % 2  # buffer i's last piece was written before this resumed
            n = min(self.CHUNK, data.numel() - start)
            with torch.cuda.stream(self.stream):
                self.bufs[i][:n].copy_(data[start:start + n], non_blocking=True)
                self.copied[i].record(self.stream)
            if pending is not None:
                yield self._ready(*pending)
            pending = (i, n)
        if pending is not None:
            yield self._ready(*pending)

    def _ready(self, i: int, n: int) -> memoryview:
        self.copied[i].synchronize()
        return memoryview(self.bufs[i].numpy())[:n]


def _leaf(obj, copiers: dict, ready):
    """(ext code, ext header + array head, data pieces) of an array-like
    leaf, or None for anything else."""
    nbytes = (obj.numel() * obj.element_size() if isinstance(obj, torch.Tensor)
              else np.asarray(obj).nbytes if isinstance(obj, (np.ndarray, np.generic)) else 0)
    if nbytes > _MAX32:
        raise ValueError(f"msgpack: an array of {nbytes} bytes is beyond bin32's 4 GiB")
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            name = "bfloat16"
        elif t.dtype in _TORCH_TO_NUMPY:
            name = np.dtype(_TORCH_TO_NUMPY[t.dtype]).name
        else:
            raise ValueError(f"msgpack: unsupported tensor dtype {t.dtype}")
        code, shape = EXT_NDARRAY, tuple(t.shape)
        if t.device.type == "cuda":
            if t.device not in copiers:
                copiers[t.device] = _DeviceCopier(t.device, ready)
            pieces = copiers[t.device].pieces(t)
        elif t.device.type == "cpu":
            t = t.contiguous()
            pieces = iter([_bytes_view((t.view(torch.int16) if name == "bfloat16" else t).numpy())])
        else:
            raise ValueError(f"msgpack: cannot encode a tensor on {t.device}")
    elif isinstance(obj, (np.ndarray, np.generic)):
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        arr = np.asarray(obj)
        if arr.dtype.name not in _DTYPES and arr.dtype.name != "bfloat16":
            raise ValueError(f"msgpack: unsupported array dtype {arr.dtype}")
        shape, name, pieces = arr.shape, arr.dtype.name, iter([_bytes_view(arr)])
    else:
        return None
    head = _array_head(shape, name, nbytes)
    return _ext_header(code, len(head) + nbytes) + head, pieces


def _bytes_view(arr: np.ndarray) -> memoryview:
    """The C-order bytes of ``arr``: a view when it is C-contiguous, else a
    copy (what flax's ``tobytes('C')`` writes)."""
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return memoryview(arr.reshape(-1).view(np.uint8))


def iter_packb(obj, *, ready=None, _copiers=None) -> Iterator:
    """The encoding of ``obj`` as a sequence of ``bytes`` and ``memoryview``
    pieces (array data is yielded in place, CUDA tensors' in chunks through
    ``_DeviceCopier``, whose stream waits for the CUDA event ``ready`` if
    one is given), so ``dump`` writes a payload of any size without
    assembling it in memory. A piece is valid until the next is taken."""
    copiers = {} if _copiers is None else _copiers
    if obj is None:
        yield b"\xc0"
    elif obj is True:
        yield b"\xc3"
    elif obj is False:
        yield b"\xc2"
    elif type(obj) is int:
        yield _int(obj)
    elif type(obj) is float:
        yield b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        yield _str(obj)
    elif type(obj) in (bytes, bytearray):
        yield _sized(len(obj), None, 0, (0xC4, 0xC5, 0xC6), "bin")
        yield bytes(obj)
    elif type(obj) is list:
        yield _sized(len(obj), 0x90, 0x0F, (0, 0xDC, 0xDD), "array")
        for item in obj:
            yield from iter_packb(item, ready=ready, _copiers=copiers)
    elif type(obj) is dict:
        yield _sized(len(obj), 0x80, 0x0F, (0, 0xDE, 0xDF), "map")
        for key in sorted(obj):  # as flax's tree_map copy orders them
            yield from iter_packb(key, ready=ready, _copiers=copiers)
            yield from iter_packb(obj[key], ready=ready, _copiers=copiers)
    else:
        leaf = _leaf(obj, copiers, ready)
        if leaf is None:
            raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")
        head, pieces = leaf
        yield head
        yield from pieces


def packb(obj) -> bytes:
    """``obj`` encoded as flax's ``msgpack_serialize`` encodes it."""
    return b"".join(bytes(p) if isinstance(p, memoryview) else p for p in iter_packb(obj))


def dump(obj, f: BinaryIO, *, ready=None) -> None:
    """Write ``packb(obj)`` to a binary file, piece by piece. CUDA tensors
    are read after the CUDA event ``ready`` if one is given, else after the
    work already on the caller's current stream."""
    for piece in iter_packb(obj, ready=ready):
        f.write(piece)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def _array_from(data: memoryview):
    """An ext 1/3 payload as a read-only numpy view of ``data`` (a bf16 one
    as a torch tensor over an int16 view)."""
    if not len(data) or data[0] != 0x93:
        raise ValueError("msgpack: malformed ndarray extension")
    shape, i = _unpack(data, 1)
    name, i = _unpack(data, i)
    head = {0xC4: "B", 0xC5: ">H", 0xC6: ">I"}.get(data[i]) if i < len(data) else None
    if head is None or not isinstance(shape, list) or not isinstance(name, str):
        raise ValueError("msgpack: malformed ndarray extension")
    n = struct.unpack_from(head, data, i + 1)[0]
    i += 1 + struct.calcsize(head)
    if i + n != len(data):
        raise ValueError("msgpack: malformed ndarray extension")
    buf = data[i:]  # the array's bytes, viewed
    if name == "bfloat16":
        arr = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    if name not in _DTYPES:
        raise ValueError(f"msgpack: unknown array dtype '{name}'")
    return np.frombuffer(buf, dtype=_DTYPES[name]).reshape(shape)


def _unpack(buf: memoryview, i: int):
    """(object, next offset) of the msgpack value at ``buf[i]``."""
    b = buf[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:
        return _map(buf, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(buf[i:i + n], "utf-8"), i + n
    if b == 0xC0:
        return None, i
    if b == 0xC2:
        return False, i
    if b == 0xC3:
        return True, i
    fixed_ext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixed_ext:
        return _ext(buf, i + 1, struct.unpack_from("b", buf, i)[0], fixed_ext[b])
    sized = {0xC4: ("bin", "B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
             0xC7: ("ext", "B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
             0xD9: ("str", "B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
             0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
             0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
    if b in sized:
        kind, fmt = sized[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        if kind == "bin":
            return bytes(buf[i:i + n]), i + n
        if kind == "str":
            return str(buf[i:i + n], "utf-8"), i + n
        if kind == "ext":
            return _ext(buf, i + 1, struct.unpack_from("b", buf, i)[0], n)
        return (_array if kind == "array" else _map)(buf, i, n)
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in scalars:
        fmt = scalars[b]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    raise ValueError(f"msgpack: unknown format byte 0x{b:02x}")


def _ext(buf: memoryview, i: int, code: int, n: int):
    data = buf[i:i + n]
    if code == EXT_NDARRAY:
        return _array_from(data), i + n
    if code == EXT_NPSCALAR:
        arr = _array_from(data)
        return (arr if isinstance(arr, torch.Tensor) else arr[()]), i + n
    raise ValueError(f"msgpack: unknown extension type {code}")


def _array(buf: memoryview, i: int, n: int):
    out = []
    for _ in range(n):
        item, i = _unpack(buf, i)
        out.append(item)
    return out, i


def _map(buf: memoryview, i: int, n: int):
    out = {}
    for _ in range(n):
        key, i = _unpack(buf, i)
        out[key], i = _unpack(buf, i)
    return out, i


def unpackb(data) -> object:
    """Decode one msgpack value from ``data`` (bytes, bytearray or a
    memoryview); arrays view ``data``. Raises ``ValueError`` on trailing
    bytes, an unknown format, extension code or dtype."""
    buf = memoryview(data).cast("B")
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"msgpack: {len(buf) - end} trailing bytes")
    return obj


def load(path) -> object:
    """Decode a msgpack file, read once into one buffer that the returned
    arrays view."""
    with open(path, "rb") as f:
        return unpackb(f.read())
