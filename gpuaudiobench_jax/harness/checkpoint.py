"""Streaming-state checkpoint/resume.

Every stateful benchmark streams through a carried pytree (IIR z, DWG
rails, modal phasors, FDTD fields, RndMem playheads -- see
``stream_body``).  A long-running synthesis service needs that carry to
survive process restarts: this module persists it as a plain ``.npz``
(one array per leaf plus a JSON header) and restores it against a
template carry from a fresh ``stream_body()`` call.

Deliberately dependency-free (NumPy only, no pickle): the tree
STRUCTURE is never serialized -- ``load_stream_state`` flattens the
template the benchmark just built and refuses to restore unless every
leaf's shape and dtype match, so a checkpoint can never smuggle a
mismatched or malicious structure into a run.  (The reference has no
analog; its runs are one-shot batch processes.  This is the
streaming-harness extension of its result-artifact discipline,
cuda/globals.cu:69-122.)
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

FORMAT = "audiobench-stream-state-v1"


def save_stream_state(
    path: str,
    carry: Any,
    *,
    benchmark: str = "",
    extra: Optional[Dict[str, Any]] = None,
) -> int:
    """Persist a streaming carry pytree to ``path`` (.npz).

    Returns the number of leaves written.  Device arrays are pulled to
    host ONCE (the header is derived from the same host copies); leaf
    order is the ``jax.tree_util`` flatten order, which is
    deterministic for a fixed carry structure.  The write is atomic
    (temp file + ``os.replace``): a crash mid-save leaves the previous
    checkpoint intact instead of a truncated zip.
    """
    import jax

    host = [np.asarray(leaf)  # one D2H per leaf
            for leaf in jax.tree_util.tree_leaves(carry)]
    header = {
        "format": FORMAT,
        "benchmark": benchmark,
        "n_leaves": len(host),
        "saved_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "leaves": [
            {"shape": list(leaf.shape), "dtype": str(leaf.dtype)}
            for leaf in host
        ],
    }
    if extra:
        header["extra"] = extra
    arrays = {f"leaf_{i:04d}": leaf for i, leaf in enumerate(host)}
    arrays["header"] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8
    )
    # Unique temp name: two concurrent savers to the same path (e.g. a
    # soak accidentally started twice with one --checkpoint) must not
    # truncate each other's half-written zip or unlink each other's
    # temp -- each writes its own file and the os.replace()s serialize.
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return len(host)


def read_header(path: str) -> Dict[str, Any]:
    raw = None
    try:
        with np.load(path) as z:
            if "header" in z.files:
                raw = bytes(z["header"])
    except Exception as e:  # BadZipFile, FileNotFoundError, numpy
        # ValueErrors from a torn member, ... -- every low-level
        # failure gets wrapped with the path, uniformly.
        raise ValueError(f"{path}: unreadable checkpoint ({e})") from e
    if raw is None:
        raise ValueError(f"{path}: no checkpoint header")
    try:
        header = json.loads(raw.decode("utf-8"))
    except Exception as e:
        raise ValueError(f"{path}: corrupt checkpoint header ({e})") from e
    if header.get("format") != FORMAT:
        raise ValueError(
            f"{path}: not a {FORMAT} checkpoint "
            f"(format={header.get('format')!r})"
        )
    return header


def load_stream_state(
    path: str,
    template: Any,
    *,
    benchmark: str = "",
) -> Tuple[Any, Dict[str, Any]]:
    """Restore a carry saved by :func:`save_stream_state`.

    ``template`` is the carry a fresh ``stream_body()`` just returned:
    its tree structure is the contract.  Every leaf's shape and dtype
    must match the checkpoint exactly, and when both sides name a
    benchmark they must agree -- resuming ModalFilterBank state into a
    DWG run fails loudly, not numerically.  Restored leaves inherit
    the template leaf's device placement and sharding (a resumed
    multi-device soak runs the SAME layout a fresh one would, not a
    host-array default).

    Returns ``(carry, header)``.
    """
    import jax

    header = read_header(path)
    if benchmark and header.get("benchmark") and \
            header["benchmark"] != benchmark:
        raise ValueError(
            f"{path}: checkpoint is for benchmark "
            f"{header['benchmark']!r}, not {benchmark!r}"
        )
    leaves, treedef = jax.tree_util.tree_flatten(template)
    if header["n_leaves"] != len(leaves):
        raise ValueError(
            f"{path}: checkpoint has {header['n_leaves']} leaves, "
            f"template has {len(leaves)}"
        )
    with np.load(path) as z:
        restored = []
        for i, tmpl in enumerate(leaves):
            key = f"leaf_{i:04d}"
            if key not in z.files:
                raise ValueError(f"{path}: missing array {key}")
            arr = z[key]
            want_shape = tuple(np.shape(tmpl))
            want_dtype = np.dtype(getattr(tmpl, "dtype", None)
                                  or np.asarray(tmpl).dtype)
            if arr.shape != want_shape or arr.dtype != want_dtype:
                raise ValueError(
                    f"{path}: leaf {i} is {arr.dtype}{list(arr.shape)}, "
                    f"template wants {want_dtype}{list(want_shape)}"
                )
            sharding = getattr(tmpl, "sharding", None)
            if sharding is not None:
                arr = jax.device_put(arr, sharding)
            restored.append(arr)
    return jax.tree_util.tree_unflatten(treedef, restored), header
