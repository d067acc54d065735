"""Versioned, checksummed training checkpoints — the port of
``lightgbm_tpu/training/checkpoint.py`` (numpy on the host, the same file
format, so checkpoints interchange with the reference package both ways).

One checkpoint file carries COMPLETE Booster round state — the forest as
raw buffers, train predictions and bagging mask exactly as the next round
consumes them, the base PRNG key, round/shrinkage counters, the
binning-schema digest and the parallel topology — so a run killed at any
round resumes BIT-IDENTICAL to the uninterrupted run.

File layout (version 1)::

    8B magic "LGBTPUC1" | u32le format version | 32B sha256(payload)
    | payload (npz: state arrays + one __meta__ JSON doc)

Durability protocol:

* **atomic write** — the file is written to a ``.tmp-`` sibling in the
  SAME directory, fsynced, then ``os.replace``d into place; a crash or
  an injected ``checkpoint_write`` fault mid-write leaves the previous
  checkpoint untouched.
* **torn-write detection** — the outer sha256 covers every payload
  byte; truncation or bit-rot anywhere raises
  :class:`CorruptCheckpointError` at load instead of resuming garbage.
* **per-field checksums** — ``__meta__`` records a crc32 per array, so
  a corruption that survives to parse time is rejected NAMING the
  damaged field.

:func:`load_latest` walks a checkpoint directory newest-first and falls
back past corrupt files, so one torn checkpoint costs at most
``checkpoint_rounds`` rounds, never the run (``keep_last`` in
:func:`save_checkpoint` bounds the disk footprint while always keeping a
fallback generation).

Loading reads host arrays only; :func:`resume_booster` puts them on the
offered Dataset's device (the card unless the Dataset lives on the CPU).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

CKPT_MAGIC = b"LGBTPUC1"
CKPT_FORMAT_VERSION = 1
_HEADER_LEN = len(CKPT_MAGIC) + 4 + 32
_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.lgckpt$")


class CheckpointError(RuntimeError):
    """Base class for checkpoint load/save failures."""


class CorruptCheckpointError(CheckpointError):
    """Torn write, truncation, or checksum mismatch.  ``field`` names
    the damaged array when the per-field crc localized it ("" for
    whole-file/header damage)."""

    def __init__(self, message: str, field: str = ""):
        super().__init__(message)
        self.field = field


class IncompatibleCheckpointError(CheckpointError):
    """Structurally valid checkpoint that cannot resume against the
    offered Dataset / params (binning schema drift, version skew, or —
    a topology this port cannot resume onto).  ``field`` names the
    offending meta field ("schema_digest", "n_devices", "merge_mode", ...;
    "" when the mismatch is not field-local) so callers can assert on the
    field, not the prose."""

    def __init__(self, message: str, field: str = ""):
        super().__init__(message)
        self.field = field


def _payload_bytes(arrays: Dict[str, np.ndarray], meta: dict) -> bytes:
    field_crcs = {
        name: zlib.crc32(np.ascontiguousarray(arr).data)
        for name, arr in arrays.items()
    }
    doc = dict(meta)
    doc["format_version"] = CKPT_FORMAT_VERSION
    doc["field_crcs"] = field_crcs
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(doc).encode(), np.uint8), **arrays)
    return buf.getvalue()


def save_state_checkpoint(arrays: Dict[str, np.ndarray], meta: dict,
                          directory: str, *, injector=None,
                          keep_last: int = 2) -> str:
    """Write an arbitrary round-state checkpoint atomically.

    The generic half of :func:`save_checkpoint`: any ``arrays`` + JSON
    ``meta`` (which must carry an integer ``iter`` naming the
    generation) gets the full durability protocol — versioned header,
    payload sha256, per-field crc32s, tmp+fsync+``os.replace``, and
    ``keep_last`` pruning.  The sweep service checkpoints fused-CV
    hyper-batch carries through this path so a sweep killed at any
    config/round resumes from the same machinery training does.

    ``injector`` is consulted at the ``checkpoint_write`` site AFTER the
    tmp file is written and BEFORE the rename — the exact window where a
    real crash would tear the file — so the chaos tests prove the
    previous checkpoint survives.  Old checkpoints beyond ``keep_last``
    are pruned (oldest first); keep_last >= 2 keeps a fallback
    generation behind the newest.
    """
    payload = _payload_bytes(arrays, meta)
    header = (CKPT_MAGIC
              + np.uint32(CKPT_FORMAT_VERSION).tobytes()
              + hashlib.sha256(payload).digest())
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{int(meta['iter']):08d}.lgckpt")
    tmp = os.path.join(directory, f".tmp-{os.path.basename(path)}")
    try:
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        if injector is not None:
            injector.check("checkpoint_write")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if keep_last and keep_last > 0:
        for old in list_checkpoints(directory)[:-keep_last]:
            os.unlink(old)
    return path


def save_checkpoint(booster, directory: str, *, injector=None,
                    keep_last: int = 2) -> str:
    """Write ``booster``'s full round state atomically; returns the path.

    Delegates to :func:`save_state_checkpoint` with the booster's own
    state snapshot — see there for the durability protocol and the
    ``checkpoint_write`` fault window.
    """
    arrays, meta = booster.checkpoint_state()
    return save_state_checkpoint(arrays, meta, directory,
                                 injector=injector, keep_last=keep_last)


def list_checkpoints(directory: str) -> List[str]:
    """Checkpoint paths in ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    names = sorted(n for n in os.listdir(directory) if _CKPT_RE.match(n))
    return [os.path.join(directory, n) for n in names]


def latest_checkpoint(directory: str) -> Optional[str]:
    paths = list_checkpoints(directory)
    return paths[-1] if paths else None


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Read + verify one checkpoint file -> ``(arrays, meta)``.

    Verification order: magic -> version -> whole-payload sha256 (torn
    writes / truncation) -> per-field crc32s (named rejection).
    """
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _HEADER_LEN or blob[:len(CKPT_MAGIC)] != CKPT_MAGIC:
        raise CorruptCheckpointError(
            f"{path}: not a lightgbm_tpu checkpoint (bad magic or "
            "truncated header)")
    version = int(np.frombuffer(
        blob[len(CKPT_MAGIC):len(CKPT_MAGIC) + 4], np.uint32)[0])
    if version != CKPT_FORMAT_VERSION:
        raise IncompatibleCheckpointError(
            f"{path}: checkpoint format v{version} != supported "
            f"v{CKPT_FORMAT_VERSION}", field="format_version")
    digest = blob[len(CKPT_MAGIC) + 4:_HEADER_LEN]
    payload = blob[_HEADER_LEN:]
    if hashlib.sha256(payload).digest() != digest:
        raise CorruptCheckpointError(
            f"{path}: payload sha256 mismatch (torn write or bit-rot)")
    try:
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = json.loads(bytes(z["__meta__"]).decode())
    except CheckpointError:
        raise
    except Exception as e:
        raise CorruptCheckpointError(
            f"{path}: payload does not parse as a checkpoint archive: "
            f"{e}") from e
    crcs = meta.get("field_crcs", {})
    for name, arr in arrays.items():
        want = crcs.get(name)
        got = zlib.crc32(np.ascontiguousarray(arr).data)
        if want is None or int(want) != got:
            raise CorruptCheckpointError(
                f"{path}: field {name!r} failed its crc32 "
                f"(stored {want}, computed {got})", field=name)
    return arrays, meta


def load_latest(directory: str) -> Tuple[Optional[str], dict]:
    """Newest VALID checkpoint in ``directory``.

    Returns ``(path, {"arrays", "meta", "rejected"})`` where
    ``rejected`` lists ``(path, error)`` for newer checkpoints that
    failed verification — a torn newest checkpoint falls back to the
    prior generation instead of killing the resume.  ``path`` is None
    when no valid checkpoint exists.
    """
    rejected: List[Tuple[str, str]] = []
    for path in reversed(list_checkpoints(directory)):
        try:
            arrays, meta = load_checkpoint(path)
            return path, {"arrays": arrays, "meta": meta,
                          "rejected": rejected}
        except CorruptCheckpointError as e:
            rejected.append((path, str(e)))
    return None, {"arrays": None, "meta": None, "rejected": rejected}


def resume_booster(source, train_set, params=None):
    """Rebuild a Booster mid-run from a checkpoint + the training data.

    ``source`` is a checkpoint path or a preloaded ``(arrays, meta)``
    pair.  Params come from the checkpoint (they pin every config the
    interrupted run used: grower, histogram precision, sampling); the
    offered Dataset must carry the SAME binning schema as the one trained
    on, verified via the stored digest (:class:`IncompatibleCheckpointError`
    otherwise — rebinned data would silently reinterpret every split
    threshold).  A checkpoint written by the reference package resumes
    here, and one written here resumes there.

    ``params`` is the RESUME run's requested config, checked against the
    checkpoint's recorded topology by :func:`validate_parallel_topology`.
    The Booster lives on ``train_set.device``.
    """
    from ..config import parse_params
    from ..data.sketch import schema_digest
    from ..models.gbdt import Booster

    if isinstance(source, (str, os.PathLike)):
        arrays, meta = load_checkpoint(os.fspath(source))
    else:
        arrays, meta = source
    params_dict = {k: v for k, v in meta["params"].items() if v is not None}
    metric = params_dict.pop("metric", None)
    ckpt_params = parse_params(params_dict, warn_unknown=False)
    if metric:
        ckpt_params.metric = metric
    train_set.construct()
    got = schema_digest(train_set.bin_mapper)
    want = meta.get("schema_digest")
    if want is not None and got != want:
        raise IncompatibleCheckpointError(
            "checkpoint was trained under a different binning schema "
            f"(digest {want[:12]}… vs this Dataset's {got[:12]}…); "
            "rebuild the Dataset from the same source data / reference "
            "before resuming", field="schema_digest")
    booster = Booster(ckpt_params, train_set)
    validate_parallel_topology(booster, meta, requested=params)
    booster.restore_checkpoint_state(arrays, meta)
    return booster


def validate_parallel_topology(booster, meta: dict, requested=None) -> None:
    """Elastic-resume gate (the reference's): reject a topology change the
    writer's state cannot reshard onto BEFORE any round runs.

    The checkpoint's arrays are in global row order, so they reshard onto
    any row mesh whose device count divides or is a multiple of the
    writer's: shard boundaries nest, placement moves, values do not.  A
    device count that neither divides nor is a multiple of the writer's,
    or another histogram merge topology (resolved, or requested by
    ``requested``'s ``histogram_merge``), raises
    :class:`IncompatibleCheckpointError` naming the field."""
    old = dict(meta.get("parallel") or {})
    old_d = int(old.get("n_devices", 1))
    mesh = getattr(booster, "_mesh", None)
    new_d = int(mesh.n_devices) if mesh is not None else 1
    if old_d != new_d and (old_d < 1 or new_d < 1 or (
            old_d % new_d and new_d % old_d)):
        raise IncompatibleCheckpointError(
            f"checkpoint was written at n_devices={old_d} and this resume "
            f"resolved n_devices={new_d}: elastic resume needs the device "
            "counts to divide one another so shard boundaries nest "
            "(field: n_devices)", field="n_devices")
    old_mode = old.get("merge_mode")
    if old_mode is not None and mesh is not None and \
            not getattr(booster, "_dp2", False) and mesh.dc == 1:
        new_mode = mesh.mode
        if new_mode != old_mode:
            raise IncompatibleCheckpointError(
                f"checkpoint trained with histogram merge_mode="
                f"{old_mode!r} but this resume resolved {new_mode!r}: "
                "mixing merge topologies changes the partial-sum order "
                "mid-forest (field: merge_mode)", field="merge_mode")
    if requested is not None and old_mode is not None:
        if hasattr(requested, "extra"):
            req_mode = (requested.extra or {}).get("histogram_merge")
        else:
            req_mode = dict(requested or {}).get("histogram_merge")
        if req_mode is not None and req_mode != old_mode:
            raise IncompatibleCheckpointError(
                f"resume config requests histogram_merge={req_mode!r} "
                f"but the checkpoint's forest grew under {old_mode!r}: "
                "mixing merge topologies changes the partial-sum order "
                "mid-forest (field: merge_mode)", field="merge_mode")
