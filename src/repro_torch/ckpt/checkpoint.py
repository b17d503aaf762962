"""Checkpoints in the reference's on-disk format (port of the save/restore
core of ``repro.ckpt.checkpoint``).

Each save writes ``step_%010d/shard_0.npz`` (one array per flattened key
path, ``/`` written as ``__``), ``manifest.json`` (step, sorted key list,
shapes/dtypes, per-array CRC32 checksums, caller ``extra``) and a terminal
``COMMIT`` marker, into a temporary directory renamed into place — a crash
mid-save is never taken for a complete checkpoint.  Key paths flatten the
parameter tree as JAX does (dict keys in sorted order, list indices), e.g.
``params/mp/0/edge/layers/5/w``, so checkpoints move between ``repro`` and
``repro_torch`` in both directions.

Trees are nested dicts/lists whose leaves are numpy arrays or tensors;
:func:`restore_partial` returns numpy leaves (``repro_torch.convert``
turns them into tensors on a device).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class CheckpointCorruption(CheckpointError):
    """A committed checkpoint's on-disk bytes disagree with its manifest."""


_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix=()) -> dict:
    """{"a/b/0/w": leaf} in JAX's flatten order (sorted dict keys, list
    order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _unflatten(tree_like, leaves: dict, prefix=()):
    """Rebuild ``tree_like``'s structure with ``leaves[key path]``."""
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return [_unflatten(v, leaves, prefix + (str(i),))
                for i, v in enumerate(tree_like)]
    return leaves["/".join(prefix)]


def _to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _checksum(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save(ckpt_dir: str | Path, step: int, tree: Any, extra: Optional[dict] = None):
    """Synchronous checkpoint save with commit marker."""
    ckpt_dir = Path(ckpt_dir)
    step_dir = ckpt_dir / f"step_{step:010d}"
    tmp = step_dir.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    np.savez(tmp / "shard_0.npz",
             **{k.replace("/", "__"): v for k, v in arrays.items()})
    manifest = dict(
        step=step,
        keys=sorted(arrays),
        shapes={k: list(v.shape) for k, v in arrays.items()},
        dtypes={k: str(v.dtype) for k, v in arrays.items()},
        checksums={k: _checksum(v) for k, v in arrays.items()},
        time=time.time(),
        extra=extra or {},
    )
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text("ok")
    if step_dir.exists():
        shutil.rmtree(step_dir)
    os.rename(tmp, step_dir)
    return step_dir


def committed_steps(ckpt_dir: str | Path) -> list[int]:
    """Ascending committed step numbers (``*.tmp`` debris never counts)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for d in ckpt_dir.iterdir():
        m = _STEP_RE.match(d.name)
        if m and (d / "COMMIT").exists():
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def peek_manifest(ckpt_dir: str | Path, step: Optional[int] = None) -> Optional[dict]:
    """Read a committed step's manifest without touching the arrays.
    Returns None when there is no committed checkpoint."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None
    path = Path(ckpt_dir) / f"step_{step:010d}" / "manifest.json"
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruption(
            f"manifest unreadable for committed step {step} under "
            f"{ckpt_dir}: {e}") from e


def restore_partial(ckpt_dir: str | Path, tree_like: Any, prefix: str,
                    step: Optional[int] = None):
    """Restore ONLY the subtree saved under ``prefix`` (e.g. ``"params"``)
    into the structure of ``tree_like`` (numpy leaves), validating the exact
    key set, shapes/dtypes against the manifest and per-array CRC32
    checksums (a mismatch raises :class:`CheckpointCorruption`).  Returns
    (tree, manifest)."""
    ckpt_dir = Path(ckpt_dir)
    committed = committed_steps(ckpt_dir)
    step = step if step is not None else (committed[-1] if committed else None)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    if step not in committed:
        raise FileNotFoundError(
            f"step {step} has no committed checkpoint under {ckpt_dir} "
            f"(committed: {committed})")
    step_dir = ckpt_dir / f"step_{step:010d}"
    manifest = peek_manifest(ckpt_dir, step)

    # sub-key (relative to prefix) -> full checkpoint key
    sub = {}
    for k in manifest["keys"]:
        if k == prefix:
            sub[""] = k
        elif k.startswith(prefix + "/"):
            sub[k[len(prefix) + 1:]] = k
    if not sub:
        avail = sorted({k.split("/", 1)[0] for k in manifest["keys"]})
        raise ValueError(
            f"checkpoint step {step} has no keys under prefix {prefix!r} — "
            f"available top-level prefixes: {avail}")

    flat = _flatten(tree_like)
    if set(sub) != set(flat):
        missing = sorted(set(sub) - set(flat))
        unexpected = sorted(set(flat) - set(sub))
        raise ValueError(
            f"checkpoint step {step} subtree {prefix!r} does not match the "
            f"restore template: keys only in checkpoint: {missing[:5]}; keys "
            f"only in template: {unexpected[:5]} — was the model config "
            "changed between save and restore?")
    for key, leaf in flat.items():
        full = sub[key]
        want_shape = tuple(manifest["shapes"][full])
        want_dtype = manifest["dtypes"][full]
        have = _to_numpy(leaf)
        if tuple(have.shape) != want_shape or str(have.dtype) != want_dtype:
            raise ValueError(
                f"checkpoint step {step} key {full!r} has shape "
                f"{want_shape}/{want_dtype} but the restore template has "
                f"{tuple(have.shape)}/{have.dtype} — the checkpoint was "
                "written with a different model configuration")

    try:
        data = np.load(step_dir / "shard_0.npz")
    except Exception as e:
        raise CheckpointCorruption(
            f"shard unreadable for committed step {step} under {ckpt_dir}: "
            f"{e}") from e
    checksums = manifest.get("checksums", {})
    leaves = {}
    with data:
        for key in flat:
            full = sub[key]
            try:
                arr = data[full.replace("/", "__")]
            except Exception as e:
                raise CheckpointCorruption(
                    f"step {step} key {full!r} unreadable from shard "
                    f"(truncated/corrupted npz): {e}") from e
            if tuple(arr.shape) != tuple(manifest["shapes"][full]):
                raise CheckpointCorruption(
                    f"step {step} key {full!r} on-disk shape "
                    f"{tuple(arr.shape)} disagrees with its manifest "
                    f"{tuple(manifest['shapes'][full])}")
            if full in checksums and _checksum(arr) != checksums[full]:
                raise CheckpointCorruption(
                    f"step {step} key {full!r} failed its checksum — the "
                    "shard was corrupted after commit")
            leaves[key] = arr
    return _unflatten(tree_like, leaves), manifest
