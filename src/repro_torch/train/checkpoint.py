"""Fault-tolerant checkpointing (port of ``repro.train.checkpoint``):
atomic writes, K-last retention, optional F2P16 payload compression through
the canonical QTensor codec (optionally bit-packed), restore by leaf name.

The on-disk format is the reference's, byte for byte: ``<dir>/step_<n>/``
holds ``data.bin`` (every leaf's buffers back to back), ``index.json``
(per leaf: shape, dtype string, codec, offsets, sizes and crc32s),
``policy.json`` when a format policy was given, and the ``COMMITTED``
marker, written last. Writes go to ``.tmp_step_<n>`` and are renamed into
place after an fsync, so a crash mid-write never corrupts the latest
checkpoint; restore only ever reads committed steps.

Leaves are named and ordered as the reference's
``jax.tree_util.keystr`` paths (``['params']['blocks']['b0']['ff']['down']``,
dict keys sorted at every level), and the port's per-layer parameters,
moments and residuals are written as the reference's stacked ``[G, ...]``
leaves (``models.convert.reference_layout``): the layers' parts go out back
to back, which is the stacked array's C-order bytes, and restore splits
them again. Each package therefore restores the other's checkpoints.

Compression: float leaves (f16/f32/f64; bf16 is written raw, as the
reference, whose numpy bf16 is not of kind "f") of at least ``min_size``
elements whose codes + scales are smaller than their raw bytes are stored
as the two leaves of a :class:`QTensor`, block capped at the last dim.
Each part is quantized where it lives, so a leaf on the card goes through
B5 before its codes and scales are copied to the host; restore decodes
through B6 (B4 for packed payloads) on the device of the target tensor.

:func:`save` is :func:`snapshot` (device work and host copies) followed by
:func:`write` (the files); ``AsyncCheckpointer`` runs the second on a
worker thread. :func:`restore` writes into the tensors of ``tree_like``
IN PLACE (no second copy of the state on the card) and returns it.

Sharded states stay mesh-agnostic: a DTensor leaf is gathered whole by
every rank of its mesh (:func:`snapshot` is then a collective, each rank
walking the leaves in the same order), and only the writer rank
(``writer=True``) quantizes and copies it to the host, so the files are
those of a one-card run. A restore into DTensors reads the whole leaf and
keeps each rank's slice, so a run may resume on another mesh shape
(elastic); ``shardings`` first places a plain tree onto a mesh, and
``lazy=True`` returns the compressed leaves as :class:`QTensor` s.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.core import qtensor as QT
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.qtensor import QTensor
from repro_torch.faults.inject import crashpoint
from repro_torch.kernels.bits import packed_nbytes
from repro_torch.models.convert import Stacked, is_layer_dict, reference_layout
from repro_torch.models.model import Model

CKPT_FMT = F2PFormat(n_bits=16, h_bits=2, flavor=Flavor.SR, signed=True)

# the reference compresses numpy float leaves of kind "f"; its bf16 is not
_COMPRESSIBLE = (torch.float16, torch.float32, torch.float64)
_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float16, torch.bfloat16, torch.float32, torch.float64, torch.int8,
    torch.int16, torch.int32, torch.int64, torch.uint8, torch.uint16,
    torch.uint32, torch.bool)}


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint failed integrity checks on read (truncated
    buffer or per-leaf checksum mismatch)."""


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Durability for the rename itself; best-effort (some filesystems
    refuse to open directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fmt_meta(fmt: F2PFormat) -> dict:
    return {"n_bits": fmt.n_bits, "h_bits": fmt.h_bits,
            "flavor": fmt.flavor.value, "signed": fmt.signed}


def _fmt_from_meta(m: dict) -> F2PFormat:
    return F2PFormat(n_bits=m["n_bits"], h_bits=m["h_bits"],
                     flavor=Flavor(m["flavor"]), signed=m["signed"])


def _pattern_len(tree) -> int | None:
    """The pattern length by which ``tree``'s parameter-named dicts stack:
    its model's, where ``tree`` is a ``Model`` or a train state whose
    ``"params"`` is one; None for a tree without a model."""
    model = tree.get("params") if isinstance(tree, dict) else tree
    return len(model.cfg.pattern) if isinstance(model, Model) else None


def flatten(tree) -> dict[str, Any]:
    """keystr name -> leaf (a tensor, or a :class:`Stacked` list of the
    layers' tensors), in the reference's order. A ``Model`` and any flat
    dict of its parameter names are laid out as the reference's params
    tree, stacked by the pattern of the tree's ``Model``; ``None`` leaves
    are skipped, as JAX flattens them away."""
    leaves = {}
    P = _pattern_len(tree)

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, nn.Module):
            node = dict(node.named_parameters())
        if isinstance(node, dict):
            if is_layer_dict(node):
                if P is None:
                    raise ValueError(
                        f"{'/'.join(path)}: per-layer names stack by the "
                        "model's pattern; save the train state or the Model "
                        "that holds them")
                node = _nest(reference_layout(node, P))
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if isinstance(node, Stacked):
            if all(p is None for p in node):
                return
            leaves[path] = Stacked(_tensor(p) for p in node)
            return
        leaves[path] = _tensor(node)

    walk(tree, ())
    return {"".join(f"['{k}']" for k in p): leaves[p] for p in sorted(leaves)}


def _nest(layout: dict) -> dict:
    out: dict = {}
    for path, leaf in layout.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def _tensor(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"checkpoint leaves are tensors, got "
                        f"{type(x).__name__}")
    return x.detach()


def _parts(leaf) -> list:
    return list(leaf) if isinstance(leaf, Stacked) else [leaf]


def _leaf_shape(leaf) -> tuple:
    parts = _parts(leaf)
    lead = (len(parts),) if isinstance(leaf, Stacked) else ()
    return lead + tuple(parts[0].shape)


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A COPY of a tensor's C-order bytes on the host, on either device: the
    train step updates parameters and moments in place, so a snapshot that
    shared a CPU tensor's memory would change under the write."""
    return t.contiguous().reshape(-1).view(torch.uint8).to(
        "cpu", copy=True).numpy()


def _codec_shrinks(shape: tuple, block: int, fmt: F2PFormat = CKPT_FMT,
                   packed: bool = False) -> bool:
    """Would codes + scales be smaller than the raw f32 bytes? Narrow last
    dims (e.g. [N, 1]: 2 B code + 4 B scale per element) stay raw."""
    blk = min(block, shape[-1])
    npad = -(-shape[-1] // blk) * blk
    lead = math.prod(shape) // shape[-1]
    if packed:
        code_bytes = packed_nbytes(npad, fmt.n_bits)
    else:
        code_bytes = npad * np.dtype(fmt.code_dtype).itemsize
    return lead * (code_bytes + (npad // blk) * 4) < 4 * math.prod(shape)


@dataclasses.dataclass
class LeafSnapshot:
    """One leaf on the host: its index entry (without offsets) and its
    buffers, the payload parts (codes or raw bytes) then the scale parts."""
    name: str
    entry: dict
    payload: list
    scales: list | None = None


def snapshot(tree: Any, *, compress: bool = False, block: int = 128,
             min_size: int = 65536, fmt: F2PFormat = CKPT_FMT, policy=None,
             packed: bool | None = None,
             writer: bool = True) -> list[LeafSnapshot]:
    """Quantize the compressed leaves where they live (B5 on the card) and
    copy every buffer to the host. ``policy`` picks each leaf's format by
    its path ``ckpt/<leaf path>``; ``packed`` stores bit-packed words.
    DTensor leaves are gathered whole first (a collective: every rank of
    the mesh calls this); a rank with ``writer=False`` only takes part in
    the gathers and returns an empty list."""
    from repro_torch.autotune.policy import path_from_keystr
    from repro_torch.launch.shardings import gather_full

    pk = QT.resolve_packed(packed)
    out = []
    for name, leaf in flatten(tree).items():
        parts = [gather_full(p, leg="ckpt.all_gather") for p in _parts(leaf)]
        if not writer:
            continue
        shape = _leaf_shape(leaf)
        stacked = isinstance(leaf, Stacked)
        entry = {"shape": list(shape),
                 "dtype": str(parts[0].dtype).removeprefix("torch.")}
        leaf_fmt, leaf_blk = fmt, block
        if policy is not None:
            leaf_fmt, leaf_blk = policy.f2p_for(
                "ckpt/" + path_from_keystr(name), (fmt, block))
        if (compress and parts[0].dtype in _COMPRESSIBLE
                and math.prod(shape) >= min_size and shape
                and _codec_shrinks(shape, leaf_blk, leaf_fmt, packed=pk)):
            # cap the block at the leaf's last dim: a 128-block on a narrow
            # leaf would pad codes up to 128 and balloon the file
            leaf_block = min(leaf_blk, shape[-1])
            qts = [QT.quantize(p.to(torch.float32), leaf_fmt,
                               block=leaf_block, packed=pk) for p in parts]
            lead = [len(parts)] if stacked else []
            entry.update(codec="qtensor", block=leaf_block,
                         fmt=_fmt_meta(leaf_fmt), packed=pk,
                         codes_shape=lead + list(qts[0].codes.shape),
                         scale_shape=lead + list(qts[0].scales.shape))
            out.append(LeafSnapshot(name, entry,
                                    [_host_bytes(q.codes) for q in qts],
                                    [_host_bytes(q.scales) for q in qts]))
        else:
            entry.update(codec="raw")
            out.append(LeafSnapshot(name, entry,
                                    [_host_bytes(p) for p in parts]))
    return out


def _write_span(f, buffers) -> tuple[int, int, int]:
    offset, crc, n = f.tell(), 0, 0
    for b in buffers:
        f.write(b)
        crc = zlib.crc32(b, crc)
        n += b.nbytes
    return offset, n, crc


def write(ckpt_dir: str, step: int, snap: list[LeafSnapshot], *,
          keep: int = 3, policy=None) -> str:
    """Atomically write a :func:`snapshot` as ``step_<step>``; prune to
    ``keep`` newest."""
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    index = {}
    with open(os.path.join(tmp, "data.bin"), "wb") as f:
        for leaf in snap:
            entry = dict(leaf.entry)
            entry["offset"], entry["nbytes"], entry["crc"] = _write_span(
                f, leaf.payload)
            if leaf.scales is not None:
                (entry["scale_offset"], entry["scale_nbytes"],
                 entry["scale_crc"]) = _write_span(f, leaf.scales)
            index[leaf.name] = entry
        _fsync_file(f)
    crashpoint("ckpt.data_written")
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump({"step": step, "leaves": index}, f)
        _fsync_file(f)
    if policy is not None:
        with open(os.path.join(tmp, "policy.json"), "w") as f:
            f.write(policy.to_json())
            _fsync_file(f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
        _fsync_file(f)
    crashpoint("ckpt.before_commit")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(ckpt_dir)
    _prune(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, *, compress: bool = False,
         keep: int = 3, block: int = 128, min_size: int = 65536,
         fmt: F2PFormat = CKPT_FMT, policy=None,
         packed: bool | None = None) -> str:
    """Atomically write ``tree`` as ``step_<step>`` (the reference's
    ``save``, arguments and defaults): :func:`snapshot` then :func:`write`.
    ``policy`` is also stored as ``policy.json`` (:func:`load_policy`)."""
    snap = snapshot(tree, compress=compress, block=block, min_size=min_size,
                    fmt=fmt, policy=policy, packed=packed)
    return write(ckpt_dir, step, snap, keep=keep, policy=policy)


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
    # stale tmp dirs of crashed writes (no COMMITTED marker: never restored)
    if os.path.isdir(ckpt_dir):
        for d in os.listdir(ckpt_dir):
            if d.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def all_steps(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")):
            out.append(int(d.split("_", 1)[1]))
    return out


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def load_policy(ckpt_dir: str, step: int | None = None):
    """The FormatPolicy saved with step ``step`` (default: latest), or None
    when the checkpoint was written without one."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None
    p = os.path.join(ckpt_dir, f"step_{step}", "policy.json")
    if not os.path.exists(p):
        return None
    from repro_torch.autotune.policy import FormatPolicy

    with open(p) as f:
        return FormatPolicy.from_json(f.read())


def _read_span(data: np.memmap, name: str, offset: int, nbytes: int,
               crc: int | None, what: str = "payload") -> bytearray:
    """One integrity-checked byte span: truncation against the file length,
    bit rot against the stored crc32 (entries without one skip it)."""
    if offset + nbytes > data.size:
        raise CheckpointCorrupt(
            f"{name}: {what} [{offset}:{offset + nbytes}] exceeds data.bin "
            f"({data.size} bytes): truncated write")
    raw = bytearray(data[offset:offset + nbytes])
    if crc is not None and zlib.crc32(raw) != crc:
        raise CheckpointCorrupt(
            f"{name}: {what} checksum mismatch (stored {crc:#010x}, "
            f"read {zlib.crc32(raw):#010x}): corrupted buffer")
    return raw


def _from_bytes(raw: bytearray, dtype: torch.dtype, shape) -> torch.Tensor:
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def _read_qtensor(name: str, e: dict, data: np.memmap) -> QTensor:
    """A compressed leaf's QTensor on the host (decode deferred), in the
    leaf's (stacked) shape."""
    fmt = _fmt_from_meta(e["fmt"]) if "fmt" in e else CKPT_FMT
    packed = bool(e.get("packed", False))
    cdt = torch.uint32 if packed else (
        torch.uint8 if fmt.n_bits <= 8 else torch.uint16)
    codes = _from_bytes(_read_span(data, name, e["offset"], e["nbytes"],
                                   e.get("crc"), "codes"),
                        cdt, e.get("codes_shape", e["shape"]))
    scales = _from_bytes(_read_span(data, name, e["scale_offset"],
                                    e["scale_nbytes"], e.get("scale_crc"),
                                    "scales"),
                         torch.float32, e["scale_shape"])
    return QTensor.from_parts(codes, scales, fmt, e["block"], e["shape"],
                              packed=packed)


def _assign(p: torch.Tensor, value: torch.Tensor) -> None:
    """Copy a whole leaf's value into ``p``: into its local slice where
    ``p`` is a DTensor (the rank keeps its part of the whole)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.shardings import local_slice

    if isinstance(p, DTensor):
        p.to_local().copy_(local_slice(value.to(p.device), p))
    else:
        p.copy_(value)


def _read_leaf(name: str, e: dict, data: np.memmap, like) -> None:
    """Decode one index entry into the tensor(s) of ``like`` in place."""
    parts = _parts(like)
    stacked = isinstance(like, Stacked)
    if tuple(e["shape"]) != _leaf_shape(like):
        raise ValueError(f"{name}: checkpoint shape {tuple(e['shape'])} != "
                         f"{_leaf_shape(like)}")
    dtype = _DTYPES[e["dtype"]]
    if e["codec"] in ("qtensor", "f2p16"):   # f2p16: pre-QTensor name
        q = _read_qtensor(name, e, data)
        shape = e["shape"][1:] if stacked else e["shape"]
        for i, p in enumerate(parts):
            c, s = (q.codes[i], q.scales[i]) if stacked else (q.codes,
                                                              q.scales)
            qt = QTensor.from_parts(c.to(p.device), s.to(p.device), q.fmt,
                                    q.block, shape, packed=q.packed)
            _assign(p, qt.dequantize(torch.float32).to(dtype))
        return
    arr = _from_bytes(_read_span(data, name, e["offset"], e["nbytes"],
                                 e.get("crc")), dtype, e["shape"])
    for i, p in enumerate(parts):
        _assign(p, arr[i] if stacked else arr)


@torch.no_grad()
def restore(ckpt_dir: str, tree_like: Any, step: int | None = None,
            shardings: Any = None, *, lazy: bool = False):
    """Restore step ``step`` (default: the latest committed) into the
    tensors of ``tree_like`` IN PLACE, matching leaves by name. Returns
    (tree_like, step).

    Mesh-agnostic: a DTensor leaf of ``tree_like`` gets its rank's slice of
    the whole leaf, so a run restores onto any mesh shape (elastic).
    ``shardings`` (the tree ``launch.shardings.train_state_specs`` returns,
    or ``{name: NamedSharding}`` for a ``Model``) first places a plain
    ``tree_like`` onto its mesh (``shard_state``). With ``lazy=True``
    nothing is written: returns ``({keystr name: leaf}, step)``, each
    compressed leaf a :class:`QTensor` in its (stacked) reference shape and
    each raw one a tensor, on the device of ``tree_like``'s leaf."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)["leaves"]
    data = np.memmap(os.path.join(d, "data.bin"), dtype=np.uint8, mode="r")
    if lazy:
        if shardings is not None:
            raise ValueError("lazy restores return host-read QTensors on "
                             "tree_like's devices; place them after")
        out = {}
        for name, like in flatten(tree_like).items():
            e, dev = index[name], _parts(like)[0].device
            if e["codec"] in ("qtensor", "f2p16"):
                q = _read_qtensor(name, e, data)
                out[name] = QTensor.from_parts(
                    q.codes.to(dev), q.scales.to(dev), q.fmt, q.block,
                    q.shape, packed=q.packed)
            else:
                out[name] = _from_bytes(
                    _read_span(data, name, e["offset"], e["nbytes"],
                               e.get("crc")),
                    _DTYPES[e["dtype"]], e["shape"]).to(dev)
        return out, step
    if shardings is not None:
        from repro_torch.launch.shardings import shard_state

        shard_state(tree_like, shardings)
    for name, like in flatten(tree_like).items():
        _read_leaf(name, index[name], data, like)
    return tree_like, step
