"""Checkpoints in both packages' formats: the port's ``.pt`` and the JAX
package's flax msgpack ``.msgpack``, read and written without flax or the
``msgpack`` package.

The JAX ``Trainer`` writes ``flax.serialization.to_bytes(TrainState)``:
msgpack of the state dict

    {"step": int32 (),
     "params": {...}, "batch_stats": {...},
     "opt_state": {"0": {"count", "mu", "nu"}    (Adam)
                        {"trace"}                  (momentum SGD),
                   "1": {"count"}}}                (the LR schedule's)

with arrays as ext type 1 (``packb((shape, dtype name, raw bytes))``),
numpy scalars as ext type 3, Python complex numbers as ext type 2, and an
array above ``MAX_CHUNK_SIZE`` bytes split into a
``{"__msgpack_chunked_array__": True, "shape", "chunks"}`` map. The codec
below reads and writes exactly that subset: maps, str, bin, ints, floats,
bool, nil, arrays and those three ext types. Anything else raises and
names itself.

The state maps onto the port's as ``weights.py`` maps the variables:
``params``/``batch_stats`` through ``from_flax``/``to_flax`` (kernels
transposed); Adam's ``count``, ``mu`` and ``nu`` become each parameter's
``step``, ``exp_avg`` and ``exp_avg_sq``; ``trace`` becomes
``momentum_buffer``; ``opt_state["1"].count``, the count the applied
learning rate is read at, is the port's ``schedule_count``. A bare
``{"params", "batch_stats"}`` file (weights only) is read as well.

The port's ``.pt`` is a ``torch.save`` dict ``{"step", "schedule_count",
"model", "optimizer"}``; one without ``schedule_count`` takes the count
from Adam's state, or from ``step`` for SGD.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from alignnet3d_tpu_torch.weights import from_flax, to_flax

SUFFIXES = (".pt", ".msgpack")
# flax.serialization.MAX_CHUNK_SIZE: larger arrays are written in chunks
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ codec

def _pack_array_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise TypeError(f"cannot write an array of dtype {arr.dtype}")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack_ext(out: bytearray, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack("b", code)
    out += data


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes):
    if n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0 <= v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < 0:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < 0:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < 0:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack(out: bytearray, obj):
    # exact types, as flax's strict_types=True packer: a numpy scalar (a
    # subclass of float for float64) goes out as ext type 3
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(out, len(data), 0, -1, (0xC4, 0xC5, 0xC6))
        out += data
    elif t in (list, tuple):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif t is dict:
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    elif t is np.ndarray:
        _pack_ext(out, _EXT_NDARRAY, _pack_array_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _pack_array_bytes(np.asarray(obj)))
    elif t is complex:
        _pack_ext(out, _EXT_COMPLEX, packb((obj.real, obj.imag)))
    else:
        raise TypeError(f"cannot write {t.__name__} to msgpack")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes, as flax's ``msgpack.packb(...,
    default=_msgpack_ext_pack, strict_types=True)`` writes it."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# the type bytes below fixint/fixmap/fixarray/fixstr: nil and bool; ints
# and floats by their struct format; bin, ext, str, array and map by the
# format of their length; fixext by its data length
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data ends at byte {len(self.data)}, "
                             f"{n} more needed at {self.pos}")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        at = self.pos
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _LENGTHS:
            n = self.unpack(_LENGTHS[b])
        elif b in _FIXEXT:
            n = _FIXEXT[b]
        else:
            raise ValueError(f"msgpack type byte 0x{b:02x} at offset {at} is "
                             f"not one flax writes")
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9 or b in _FIXEXT:
            return self.ext(self.unpack(">b"), bytes(self.take(n)))
        if b <= 0xDB:
            return self.str(n)
        if b <= 0xDD:
            return self.array(n)
        return self.map(n)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    @staticmethod
    def ext(code: int, data: bytes):
        if code == _EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _array_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = unpackb(data)
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one flax writes "
                         f"(1 ndarray, 2 complex, 3 numpy scalar)")


def _array_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"array dtype {name!r} is not readable "
                         f"without flax") from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def unpackb(data: bytes):
    """One msgpack object of the subset flax writes; trailing bytes raise."""
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         f"msgpack object")
    return obj


def _chunk_leaves(tree):
    """Arrays above MAX_CHUNK_SIZE bytes -> flax's chunked maps."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            value = _chunk_leaves(value)
        elif type(value) is np.ndarray and value.nbytes > MAX_CHUNK_SIZE:
            size = max(1, int(MAX_CHUNK_SIZE / value.dtype.itemsize))
            flat = value.reshape(-1)
            value = {_CHUNKED: True,
                     "shape": {str(i): d for i, d in enumerate(value.shape)},
                     "chunks": {str(i): flat[s:s + size] for i, s in
                                enumerate(range(0, flat.size, size))}}
        out[key] = value
    return out


def _unchunk_leaves(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk_leaves(value) for key, value in tree.items()}


def to_bytes(tree: dict) -> bytes:
    """A state dict (nested dicts of numpy arrays) as flax's
    ``msgpack_serialize`` writes it, large arrays chunked."""
    return packb(_chunk_leaves(tree))


def msgpack_restore(data: bytes):
    """Counterpart of ``flax.serialization.msgpack_restore``."""
    return _unchunk_leaves(unpackb(data))


# ------------------------------------------------ TrainState <-> the port

def _flax_tree(named: dict) -> dict:
    return to_flax(named)["params"]


def _named(tree: dict) -> dict:
    return from_flax({"params": tree, "batch_stats": {}})


def train_state_tree(model: torch.nn.Module, optimizer, step: int,
                     schedule_count: int) -> dict:
    """The port's state as the JAX ``TrainState`` dict, for ``to_bytes``."""
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    per_param = [optimizer.state.get(params[n], {}) for n in names]

    def moments(key):
        return _flax_tree({n: s.get(key, torch.zeros_like(params[n]))
                           for n, s in zip(names, per_param)})

    if isinstance(optimizer, torch.optim.Adam):
        steps = {int(s["step"]) for s in per_param if "step" in s}
        if len(steps) > 1:
            raise ValueError(f"Adam's parameters are at different steps "
                             f"{sorted(steps)}: one optax count cannot "
                             f"hold them")
        first = {"count": np.asarray(steps.pop() if steps else 0, np.int32),
                 "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")}
    elif isinstance(optimizer, torch.optim.SGD):
        first = {"trace": moments("momentum_buffer")}
    else:
        raise TypeError(f"no optax layout for {type(optimizer).__name__}")
    variables = to_flax(model.state_dict())
    return {"step": np.asarray(step, np.int32),
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": {"0": first,
                          "1": {"count": np.asarray(schedule_count,
                                                    np.int32)}}}


def _load_opt_state(optimizer, model, opt_state: dict, path: str):
    first = opt_state["0"]
    names = [n for n, _ in model.named_parameters()]
    if isinstance(optimizer, torch.optim.Adam):
        if "mu" not in first:
            raise ValueError(f"{path}: the run's optimizer is not Adam "
                             f"(opt_state holds {sorted(first)})")
        mu, nu = _named(first["mu"]), _named(first["nu"])
        count = torch.tensor(float(first["count"]), dtype=torch.float32)
        state = {i: {"step": count.clone(), "exp_avg": mu[n],
                     "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    elif isinstance(optimizer, torch.optim.SGD):
        if "trace" not in first:
            raise ValueError(f"{path}: the run's optimizer is not momentum "
                             f"SGD (opt_state holds {sorted(first)})")
        trace = _named(first["trace"])
        state = {i: {"momentum_buffer": trace[n]}
                 for i, n in enumerate(names)}
    else:
        raise TypeError(f"no optax layout for {type(optimizer).__name__}")
    optimizer.load_state_dict({
        "state": state,
        "param_groups": optimizer.state_dict()["param_groups"]})


def _pt_schedule_count(ckpt: dict) -> int:
    """The schedule count of a ``.pt``; one written before the key existed
    counts as many updates as Adam's state holds, or its step."""
    if "schedule_count" in ckpt:
        return int(ckpt["schedule_count"])
    steps = [s["step"] for s in ckpt["optimizer"]["state"].values()
             if "step" in s]
    return int(steps[0]) if steps else int(ckpt["step"])


# ------------------------------------------------------------------ files

def find(path: str) -> str | None:
    """``path`` itself when it names its format, else ``path.pt`` when it
    exists, else ``path.msgpack`` when it exists, else None."""
    if path.endswith(SUFFIXES):
        return path if os.path.isfile(path) else None
    for suffix in SUFFIXES:
        if os.path.isfile(path + suffix):
            return path + suffix
    return None


def resolve(path: str) -> str:
    """:func:`find`, raising when there is no such file."""
    found = find(path)
    if found is None:
        names = ([path] if path.endswith(SUFFIXES)
                 else [path + s for s in SUFFIXES])
        raise FileNotFoundError(f"no checkpoint: {' nor '.join(names)} "
                                f"exists")
    return found


def read_msgpack(path: str) -> dict:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def state_dict_from_file(path: str, device="cpu") -> dict:
    """The model weights of a ``.pt`` or ``.msgpack`` checkpoint (full
    training state or bare variables) as a port ``state_dict``."""
    path = resolve(path)
    if path.endswith(".msgpack"):
        tree = read_msgpack(path)
        return {k: v.to(device) for k, v in from_flax(tree).items()}
    return torch.load(path, map_location=device, weights_only=True)["model"]


def load(path: str, model: torch.nn.Module, optimizer=None) -> dict:
    """Load a checkpoint of either format into ``model`` and, when given
    and the file holds one, ``optimizer``. Returns ``{"step",
    "schedule_count"}``; ``step`` is None for a weights-only file."""
    path = resolve(path)
    device = next(model.parameters()).device
    if path.endswith(".msgpack"):
        tree = read_msgpack(path)
        model.load_state_dict(from_flax(tree))
        if "opt_state" not in tree:
            return {"step": None, "schedule_count": 0}
        if optimizer is not None:
            _load_opt_state(optimizer, model, tree["opt_state"], path)
        return {"step": int(tree["step"]),
                "schedule_count": int(tree["opt_state"]["1"]["count"])}
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt["model"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    return {"step": int(ckpt["step"]),
            "schedule_count": _pt_schedule_count(ckpt)}


def save(path: str, model: torch.nn.Module, optimizer, step: int,
         schedule_count: int):
    """Write the training state as ``.msgpack`` (the JAX ``TrainState``
    layout) or, for any other name, as the port's ``.pt``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".msgpack"):
        with open(path, "wb") as f:
            f.write(to_bytes(train_state_tree(model, optimizer, step,
                                              schedule_count)))
        return
    torch.save({"step": step, "schedule_count": schedule_count,
                "model": model.state_dict(),
                "optimizer": optimizer.state_dict()}, path)
