"""Checkpoints with atomic commit and async save (counterpart of
``repro/checkpoint/checkpointer.py``, in the same on-disk format).

Layout:  <dir>/step_<n>/
           manifest.json        {step, leaves: {name: {file, shape, dtype}}, extra}
           <leaf-name>.npy      one full array per leaf
           COMMITTED            written last; the staging directory is
                                renamed into place, so a step is atomic

A tree is nested dicts (keys sorted), lists/tuples and dataclasses of
tensors or arrays.  A bfloat16 leaf is written as its uint16 payload with
``"dtype": "bfloat16"`` in the manifest, as the reference writes it, and
read back bit for bit (no ``ml_dtypes`` needed).  Leaf names follow the reference's: the path's dict
keys and list indices joined by ``/``, a dataclass field as ``.field``
(``.ta_state`` for a ``CoTMModel``), so either package restores the
other's checkpoints.  Tensors are copied to the host to be written; a
restore gives tensors on the template's device (or ``device``; the host
for a template of meta tensors, which gives shapes only).

:func:`save_servable` stores a frozen register image as the reference
does: ``include`` uint8, ``include_packed`` as uint32 words,
``nonempty`` bool and ``weights`` int8, with the version stamp and the
tuned plan's JSON (``TunedPlan.to_json``) in ``extra``.  Beside the plan
it writes ``extra["tuned_plan_device"]``, the device the plan was measured
on (``autotune.device_name``: the card's name, or ``"cpu"``); the
reference reads ``extra`` with ``.get`` and ignores it.  A restore
applies a plan only when it is this package's, for this device
(:func:`plan_from_extra`): a plan with no stamp (every plan the JAX
package writes), a stamp naming another device, or an entry this package
cannot dispatch is foreign, and restores as None, as a malformed one
does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = [
    "Checkpointer",
    "latest_step",
    "plan_from_extra",
    "restore_pytree",
    "restore_servable",
    "save_pytree",
    "save_servable",
]


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in the reference's leaf order and naming."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (str(i),))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += _flatten(getattr(tree, f.name), prefix + ("." + f.name,))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(template: Any, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, prefix + (str(i),))
                              for i, v in enumerate(template))
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves, prefix + ("." + f.name,))
            for f in dataclasses.fields(template)})
    return leaves["/".join(prefix)]


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """``(array to write, logical dtype)``.  numpy has no bfloat16 of its
    own, so a bfloat16 leaf (a tensor, or an ``ml_dtypes`` array the caller
    made) is written as its uint16 payload under the dtype ``"bfloat16"``,
    as the reference writes it."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _bf16_from_payload(arr: np.ndarray) -> torch.Tensor:
    """A bfloat16 tensor from its uint16 payload (bit for bit)."""
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)


def _write(host: List[Tuple[str, np.ndarray, str]], directory: str, step: int,
           extra: Optional[Dict]) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    staging = final + ".tmp"
    if os.path.exists(staging):
        shutil.rmtree(staging)
    os.makedirs(staging, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, arr, dtype in host:
        fname = name.replace("/", "__") + ".npy"
        np.save(os.path.join(staging, fname), arr)
        manifest["leaves"][name] = {"file": fname, "shape": list(arr.shape),
                                    "dtype": dtype}
    with open(os.path.join(staging, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    open(os.path.join(staging, "COMMITTED"), "w").close()
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(staging, final)
    return final


def _host_leaves(tree: Any):
    return [(name, *_to_numpy(leaf)) for name, leaf in _flatten(tree)]


def save_pytree(tree: Any, directory: str, step: int, extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save; returns the committed directory."""
    return _write(_host_leaves(tree), directory, step, extra)


def _committed_steps(directory: str) -> list:
    """``(step, dirname)`` of committed checkpoints, ascending; entries
    whose suffix is not a number are skipped."""
    out = []
    for d in os.listdir(directory):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        try:
            step = int(d[5:])
        except ValueError:
            continue
        if os.path.exists(os.path.join(directory, d, "COMMITTED")):
            out.append((step, d))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _committed_steps(directory)
    return steps[-1][0] if steps else None


def _leaf_like(arr: np.ndarray, dtype: Optional[str], tmpl: Any, device) -> Any:
    """``arr`` (written under the logical ``dtype``) in the template leaf's
    dtype: a tensor (on ``device``, else the template's device) for a
    tensor template, an array otherwise."""
    if isinstance(tmpl, torch.Tensor):
        if dtype == "bfloat16":
            t = _bf16_from_payload(arr)
        else:
            if tmpl.dtype == torch.int32 and arr.dtype == np.uint32:
                arr = arr.view(np.int32)             # packed words: same bits
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if device is None:
            device = "cpu" if tmpl.is_meta else tmpl.device
        return t.to(tmpl.dtype).to(device)
    if dtype == "bfloat16":
        arr = _bf16_from_payload(arr).float().numpy()
    return arr.astype(np.asarray(tmpl).dtype)


def restore_pytree(
    template: Any, directory: str, step: Optional[int] = None, device=None
) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``template``; returns (tree, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for name, tmpl in _flatten(template):
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint at step {step} missing leaf {name}")
        arr = np.load(os.path.join(d, meta["file"]))
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"leaf {name}: checkpoint shape {arr.shape} != template {tuple(tmpl.shape)}"
            )
        leaves[name] = _leaf_like(arr, meta.get("dtype"), tmpl, device)
    return _unflatten(template, leaves), step, manifest.get("extra", {})


def save_servable(servable: Any, directory: str, step: int) -> str:
    """Checkpoint a frozen :class:`~repro_torch.serve.servable.ServableModel`
    in the reference's layout; the sparsity image is derived, not stored."""
    tree = {
        "include": servable.include,
        "include_packed": servable.include_packed.detach().cpu().numpy().view(np.uint32),
        "nonempty": servable.nonempty,
        "weights": servable.weights,
    }
    extra: Dict[str, Any] = {}
    if servable.version is not None:
        extra["servable_version"] = servable.version.as_dict()
    if servable.tuned is not None:
        from repro_torch.serve.autotune import device_name

        extra["tuned_plan"] = servable.tuned.to_json()
        extra["tuned_plan_device"] = device_name(servable.include_packed.device)
    return save_pytree(tree, directory, step, extra)


def plan_from_extra(extra: Dict, device) -> Optional[Any]:
    """The :class:`~repro_torch.serve.autotune.TunedPlan` in a manifest's
    ``extra``, or None: none is there, it is malformed, or it is foreign
    (no ``tuned_plan_device`` stamp, a stamp naming another device than
    ``device``, or an entry :func:`~repro_torch.serve.autotune.plan_applies`
    refuses)."""
    from repro_torch.serve.autotune import TunedPlan, device_name, plan_applies

    text = extra.get("tuned_plan")
    if not text or extra.get("tuned_plan_device") != device_name(torch.device(device)):
        return None
    try:
        plan = TunedPlan.from_json(text)
    except (ValueError, KeyError, TypeError):
        return None           # malformed: restore the model anyway
    return plan if plan_applies(plan) else None


def restore_servable(
    config: Any, directory: str, step: Optional[int] = None, device=None
) -> Tuple[Any, int]:
    """Restore a :func:`save_servable` checkpoint (written by either
    package) as a :class:`~repro_torch.serve.servable.ServableModel` on
    ``device`` (the card unless ``"cpu"`` is named, see
    :func:`repro_torch.resolve_device`), with its version stamp (v0 when
    the manifest has none) and its tuned plan when it was measured on that
    device (:func:`plan_from_extra`; else None).  Returns
    ``(servable, step)``."""
    from repro_torch.serve.servable import ServableModel, ServableVersion

    c, n, m, w = config.n_clauses, config.n_literals, config.n_classes, config.patch.n_words
    template = {
        "include": torch.zeros((c, n), dtype=torch.uint8),
        "include_packed": torch.zeros((c, w), dtype=torch.int32),
        "nonempty": torch.zeros((c,), dtype=torch.bool),
        "weights": torch.zeros((m, c), dtype=torch.int8),
    }
    device = resolve_device(device)
    tree, step, extra = restore_pytree(template, directory, step, device=device)
    extra = extra or {}
    servable = ServableModel(
        include=tree["include"],
        include_packed=tree["include_packed"],
        nonempty=tree["nonempty"],
        weights=tree["weights"],
        config=config,
        version=ServableVersion.from_dict(extra.get("servable_version")),
        tuned=plan_from_extra(extra, device),
    )
    return servable, step


class Checkpointer:
    """Async checkpointer: ``save`` copies the tree to the host, then writes
    it on a thread and returns; the previous save is joined first (one in
    flight).  Keeps the newest ``keep`` checkpoints.  A failed save is
    raised on the next ``wait()`` or ``save()``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        """Join the in-flight save; raise its failure, once."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, tree: Any, step: int, extra: Optional[Dict] = None, *, fresh: bool = False):
        """Save ``tree`` as ``step`` on a thread.  The host copy is made on
        the caller's thread, since the caller may update its tensors in
        place after this returns; with ``fresh`` the caller hands over host
        tensors or arrays that nothing else holds, written as they are."""
        self.wait()
        host = _host_leaves(tree)
        if not fresh:
            host = [(name, arr.copy(), dtype) for name, arr, dtype in host]

        def work():
            try:
                _write(host, self.directory, step, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 -- raised on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        for _, d in _committed_steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d))

    def restore(self, template: Any, step: Optional[int] = None, device=None):
        self.wait()
        return restore_pytree(template, self.directory, step, device=device)
