"""The wire format of the multi-host backend: SiteJob results as bytes.

``pack_payload`` pickles an arbitrary result — ``TimedResult``s,
NamedTuples such as ``SuffStats``/``MergeResult``, dataclasses (frozen
ones such as ``TransactionDB`` included), the itemset dicts inside
``LocalMineResult`` — with every ``torch.Tensor`` in it, wherever it sits,
reduced to its bytes on the host plus its dtype, shape and device type.
A CUDA tensor therefore never pickles with its device index: it is staged
through host memory like any other.  ``unpack_payload`` rebuilds each
tensor on the current device of its type in the receiving process, with
the same dtype (bfloat16 included), shape and bits, contiguous.

Containers keep their own order: dict keys are not re-sorted.  (The JAX
package's ``tree_map`` sorts them; every consumer in both packages looks
keys up or sorts before it iterates.)  Unpickle only what a process of the
same run packed: unpickling can run arbitrary code.
"""

from __future__ import annotations

import io
import pickle
from typing import Any

import numpy as np
import torch


def _receiving_device(device_type: str) -> torch.device:
    """The current device of ``device_type`` in this process."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def _rebuild_tensor(raw: bytes, dtype: str, shape: tuple, device_type: str) -> torch.Tensor:
    dt = getattr(torch, dtype)
    if raw:
        flat = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).copy()).view(dt)
    else:
        flat = torch.empty((0,), dtype=dt)
    return flat.reshape(shape).to(_receiving_device(device_type))


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            host = obj.detach().to("cpu").contiguous()
            raw = host.reshape(-1).view(torch.uint8).numpy().tobytes() if host.numel() else b""
            dtype = str(host.dtype).removeprefix("torch.")
            return _rebuild_tensor, (raw, dtype, tuple(host.shape), obj.device.type)
        return NotImplemented


def pack_payload(obj: Any) -> bytes:
    """Serialize a SiteJob result for the all-gather wire.  The inverse is
    :func:`unpack_payload`."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def unpack_payload(data: bytes) -> Any:
    """Deserialize a :func:`pack_payload` wire payload; tensors land on
    this process's current device of the type they left."""
    return pickle.loads(data)
