"""Checkpoints in the reference's on-disk format (port of
``repro.ckpt.checkpoint``).

Each save writes ``step_%010d/shard_0.npz`` (one array per flattened key
path, ``/`` written as ``__``), ``manifest.json`` (step, sorted key list,
shapes/dtypes, per-array CRC32 checksums, caller ``extra``) and a terminal
``COMMIT`` marker, into a temporary directory renamed into place — a crash
mid-save is never taken for a complete checkpoint.  Key paths flatten the
parameter tree as JAX does (dict keys in sorted order, list indices), e.g.
``params/mp/0/edge/layers/5/w``, so checkpoints move between ``repro`` and
``repro_torch`` in both directions.

Trees are nested dicts/lists whose leaves are numpy arrays or tensors.
:func:`restore` and :func:`restore_partial` validate BEFORE they rebuild
the tree: the template's keys against the manifest's (missing and
unexpected keys named), each leaf's shape and dtype (a drift names the
key), each array's checksum (a mismatch raises
:class:`CheckpointCorruption` naming the key).  A leaf comes back as the
template's leaf is: a tensor (on ``device``, else on the template leaf's
own device) or a numpy array.  Every process of a run holds the
replicated parameters, so nothing is re-sharded: a checkpoint written on
R ranks restores onto R' as it is.  :func:`restore_with_fallback` walks
committed steps newest first past corrupted ones; :func:`prune` keeps the
newest steps; :class:`AsyncCheckpointer` saves off-thread from an owned
host snapshot and surfaces a failed save on the next ``save``/``wait``.

Fault injection for tests lives behind :func:`set_fault_hook`: ``save``
calls the hook at the two stages where a real crash corrupts state
("arrays_written" — shard on disk, no manifest/COMMIT; "pre_commit" —
everything but COMMIT); it may truncate files or raise (see
``repro_torch.runtime.fault_tolerance.FaultPlan``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class CheckpointCorruption(CheckpointError):
    """A committed checkpoint's on-disk bytes disagree with its manifest
    (truncated/bit-flipped shard, unreadable npz, checksum mismatch).
    Fallback-eligible: ``restore_with_fallback`` skips to the previous
    committed step."""


_STEP_RE = re.compile(r"^step_(\d+)$")

# test injection point: callable(stage, step, step_dir) invoked by ``save``
# at "arrays_written" and "pre_commit"; may mutate files and/or raise
_fault_hook: Optional[Callable[[str, int, Path], None]] = None


def set_fault_hook(fn: Optional[Callable[[str, int, Path], None]]):
    """Install a save-path fault-injection hook; returns the previous one."""
    global _fault_hook
    prev, _fault_hook = _fault_hook, fn
    return prev


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


def _snapshot(leaf) -> np.ndarray:
    """An owned host copy of the leaf: nothing the caller does to it later
    (an in-place optimizer step) reaches the copy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _shape_dtype(leaf) -> tuple:
    """(shape, numpy dtype name) of a template leaf, without a host copy."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return tuple(arr.shape), str(arr.dtype)


def _checksum(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _write(ckpt_dir: Path, step: int, arrays: dict, extra: Optional[dict]):
    step_dir = ckpt_dir / f"step_{step:010d}"
    tmp = step_dir.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "shard_0.npz",
             **{k.replace("/", "__"): v for k, v in arrays.items()})
    if _fault_hook is not None:
        _fault_hook("arrays_written", step, tmp)
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
    if _fault_hook is not None:
        _fault_hook("pre_commit", step, tmp)
    (tmp / "COMMIT").write_text("ok")
    if step_dir.exists():
        shutil.rmtree(step_dir)
    os.rename(tmp, step_dir)
    return step_dir


def save(ckpt_dir: str | Path, step: int, tree: Any, extra: Optional[dict] = None):
    """Synchronous checkpoint save with commit marker."""
    arrays = {k: _snapshot(v) for k, v in _flatten(tree).items()}
    return _write(Path(ckpt_dir), step, arrays, extra)


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


def _committed(ckpt_dir: Path, step: Optional[int]) -> int:
    committed = committed_steps(ckpt_dir)
    step = step if step is not None else (committed[-1] if committed else None)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    if step not in committed:
        raise FileNotFoundError(
            f"step {step} has no committed checkpoint under {ckpt_dir} "
            f"(committed: {committed})")
    return step


def _load(ckpt_dir: Path, step: int, manifest: dict, tree_like, keys: dict,
          what: str, device):
    """Validate ``tree_like`` (template key -> checkpoint key ``keys``)
    against the manifest, then read, check and rebuild it."""
    flat = _flatten(tree_like)
    if set(keys) != set(flat):
        missing = sorted(keys[k] for k in set(keys) - set(flat))
        unexpected = sorted(set(flat) - set(keys))
        raise ValueError(
            f"checkpoint step {step}{what} does not match the restore template: "
            f"keys only in checkpoint: {missing[:5]}; keys only in template: "
            f"{unexpected[:5]} — was the model/optimizer config changed "
            "between save and restore?")
    for key, leaf in flat.items():
        full = keys[key]
        want = (tuple(manifest["shapes"][full]), manifest["dtypes"][full])
        have = _shape_dtype(leaf)
        if have != want:
            raise ValueError(
                f"checkpoint step {step} key {full!r} has shape "
                f"{want[0]}/{want[1]} but the restore template has "
                f"{have[0]}/{have[1]} — the checkpoint was written with a "
                "different model/optimizer configuration")

    try:
        data = np.load(ckpt_dir / f"step_{step:010d}" / "shard_0.npz")
    except Exception as e:
        raise CheckpointCorruption(
            f"shard unreadable for committed step {step} under {ckpt_dir}: "
            f"{e}") from e
    checksums = manifest.get("checksums", {})
    leaves = {}
    with data:
        for key, leaf in flat.items():
            full = keys[key]
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
                    "shard was corrupted after commit; restore_with_fallback "
                    "skips to the previous committed step")
            if isinstance(leaf, torch.Tensor):
                arr = torch.from_numpy(arr).to(
                    leaf.device if device is None else device)
            leaves[key] = arr
    return _unflatten(tree_like, leaves)


def restore(ckpt_dir: str | Path, tree_like: Any, step: Optional[int] = None,
            device=None):
    """Restore into the structure of ``tree_like`` (values replaced), after
    the validation of the module docstring.  Returns (tree, manifest).

    ``device``: where tensor leaves land (default: each template leaf's
    own device) — the port's stand-in for the reference's ``shardings``."""
    ckpt_dir = Path(ckpt_dir)
    step = _committed(ckpt_dir, step)
    manifest = peek_manifest(ckpt_dir, step)
    keys = {k: k for k in manifest["keys"]}
    return _load(ckpt_dir, step, manifest, tree_like, keys, "", device), manifest


def restore_partial(ckpt_dir: str | Path, tree_like: Any, prefix: str,
                    step: Optional[int] = None, device=None):
    """Restore ONLY the subtree saved under ``prefix`` (e.g. ``"params"``)
    into the structure of ``tree_like``, with :func:`restore`'s validation
    of that subset.  A ``prefix`` absent from the checkpoint raises
    ValueError naming the prefixes that do exist.  Returns (tree,
    manifest)."""
    ckpt_dir = Path(ckpt_dir)
    step = _committed(ckpt_dir, step)
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
    tree = _load(ckpt_dir, step, manifest, tree_like, sub,
                 f" subtree {prefix!r}", device)
    return tree, manifest


def restore_with_fallback(ckpt_dir: str | Path, tree_like: Any, device=None):
    """Restore the newest committed step that validates, falling back past
    corrupted ones (checksum failures, truncated shards, unreadable
    manifests).  Template mismatches (wrong shapes/keys — a config problem,
    not a disk problem) propagate immediately.  Raises FileNotFoundError
    when no committed step survives validation."""
    steps = committed_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    last_err: Optional[BaseException] = None
    for step in reversed(steps):
        try:
            return restore(ckpt_dir, tree_like, step=step, device=device)
        except CheckpointCorruption as e:
            print(f"[ckpt] step {step} corrupted, falling back: {e}")
            last_err = e
    raise FileNotFoundError(
        f"no valid committed checkpoint under {ckpt_dir} "
        f"({len(steps)} committed steps, all corrupted; last error: "
        f"{last_err})")


def prune(ckpt_dir: str | Path, keep: int = 3):
    """Delete old committed steps, keeping the newest ``keep``.  The newest
    committed step is never deleted, even with ``keep <= 0``."""
    keep = max(int(keep), 1)
    ckpt_dir = Path(ckpt_dir)
    for s in committed_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:010d}", ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpointing: snapshot to host, save off-thread.

    ``save`` takes an owned host copy of every leaf before it returns (a
    CUDA leaf's copy waits for the work that produces it), so the caller
    may update the tree in place at once.  A failed save is raised on the
    next ``wait()`` (or the implicit wait inside the next ``save()``) —
    the resilient driver treats it like any other step failure and
    restores from the previous committed step."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        arrays = {k: _snapshot(v) for k, v in _flatten(tree).items()}

        def work():
            try:
                _write(self.dir, step, arrays, extra)
                prune(self.dir, self.keep)
            except BaseException as e:   # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
