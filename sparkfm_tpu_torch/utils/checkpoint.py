"""Checkpoints: a fitted model (:func:`save`, :func:`restore`, which
``api.py::FMModel`` and ``DeepFMModel`` use) and training state
(:class:`Checkpointer`, which ``training/trainer.py::train_sgd`` and
``models/deepfm.py::train_deepfm`` use). Port of
``sparkfm_tpu/utils/checkpoint.py``: the JAX package uses Orbax, the port
``torch.save`` of a dict of tensors with a JSON file beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from sparkfm_tpu_torch.models.deepfm import DeepFMState
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.solvers.sgd import SGDState
from sparkfm_tpu_torch.solvers.sgd_fused import FusedState

PARAMS_FILE = "params.pt"
META_FILE = "meta.json"
STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"
_STATE_TYPES = {t.__name__: t for t in (FusedState, SGDState, FMParams)}
_TOWER = ("mlp_w", "mlp_b", "smw", "smb")     # DeepFMState's tuples


def save(directory: str, state: Dict[str, torch.Tensor], meta: dict) -> None:
    """Write ``state`` (tensors, copied to the host) and ``meta``."""
    os.makedirs(directory, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               os.path.join(directory, PARAMS_FILE))
    with open(os.path.join(directory, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)


def restore(directory: str, device) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state on ``device``, meta) as written by :func:`save`."""
    state = torch.load(os.path.join(directory, PARAMS_FILE),
                       map_location=device, weights_only=True)
    with open(os.path.join(directory, META_FILE)) as f:
        meta = json.load(f)
    return state, meta


class LayoutMismatch(ValueError):
    """A checkpoint's tensors differ in names, shapes or dtypes from the
    template they are restored into."""


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """A training state's tensors by name: the fields of a
    :class:`FusedState` or :class:`SGDState` (its parameters as
    ``params.w0``, ``params.w``, ``params.v``), of :class:`FMParams`, or
    of a ``DeepFMState`` (its FM state's as ``fm.<name>``, its tower as
    ``mlp_w.<layer>``, ``mlp_b.<layer>``, ``smw.<layer>``,
    ``smb.<layer>``)."""
    if isinstance(state, FMParams):
        return {"w0": state.w0, "w": state.w, "v": state.v}
    if isinstance(state, DeepFMState):
        out = {f"fm.{k}": t for k, t in state_tensors(state.fm).items()}
        for name in _TOWER:
            out.update((f"{name}.{i}", t)
                       for i, t in enumerate(getattr(state, name)))
        return out
    if not isinstance(state, (FusedState, SGDState)):
        raise TypeError(f"no checkpoint layout for {type(state).__name__}; "
                        "expected FusedState, SGDState, FMParams or "
                        "DeepFMState")
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, FMParams):
            out.update({f"{f.name}.{k}": t
                        for k, t in state_tensors(value).items()})
        else:
            out[f.name] = value
    return out


def _build(kind: str, tensors: Dict[str, torch.Tensor]):
    """The state of type ``kind`` from its :func:`state_tensors`."""
    if kind == "FMParams":
        return FMParams(tensors["w0"], tensors["w"], tensors["v"])
    if kind == "DeepFMState":
        fm = {k[3:]: t for k, t in tensors.items() if k.startswith("fm.")}
        tower = {name: tuple(tensors[f"{name}.{i}"] for i in range(sum(
            k.startswith(name + ".") for k in tensors))) for name in _TOWER}
        return DeepFMState(
            fm=_build("FusedState" if "table" in fm else "SGDState", fm),
            **tower)
    if kind == "SGDState":
        tensors = dict(tensors)
        params = FMParams(*(tensors.pop(f"params.{k}")
                            for k in ("w0", "w", "v")))
        return SGDState(params=params, **tensors)
    return _STATE_TYPES[kind](**tensors)


class Checkpointer:
    """Saves and restores a training state by step number under
    ``directory``, one subdirectory a step, keeping the newest
    ``max_to_keep``. A step is written to a temporary directory and renamed
    into place, so a crash mid-save leaves the last good checkpoint. With
    ``async_save`` the state is copied to the host synchronously (the
    steps that follow update the device tensors in place) and written by a
    background thread; :meth:`wait` blocks until it is on disk and raises
    its error, if it had one. Usable as a context manager, which closes
    it."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Save ``state`` (FusedState, SGDState, FMParams or
        DeepFMState) and a small JSON ``extra`` dict as ``step``."""
        host = {k: t.detach().to("cpu", copy=True)
                for k, t in state_tensors(state).items()}
        payload = {"kind": type(state).__name__, "tensors": host}
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, payload, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, payload, extra)

    def _write_async(self, step, payload, extra) -> None:
        try:
            self._write(step, payload, extra)
        except BaseException as e:      # raised by wait(), in the caller
            self._error = e

    def _write(self, step: int, payload: dict, extra) -> None:
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if extra is not None:
            with open(os.path.join(tmp, EXTRA_FILE), "w") as f:
                json.dump(extra, f)
        if os.path.exists(final):       # a step saved again replaces it
            old = final + f".old-{os.getpid()}"
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        if self.max_to_keep:
            for old_step in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old_step), ignore_errors=True)

    def restore(self, step: Optional[int] = None,
                template: Any = None) -> Tuple[Any, Dict[str, Any]]:
        """(state, extra) of ``step`` (default: the latest). With a
        ``template`` state, the saved tensors must have its type, names,
        shapes and dtypes (else :class:`LayoutMismatch`, a ValueError) and
        land on its tensors' devices; without one, on the CPU. Raises
        ``FileNotFoundError`` when there is nothing to restore; a corrupt
        file raises what ``torch.load`` raises."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint under {self.directory}")
        path = self._step_dir(step)
        payload = torch.load(os.path.join(path, STATE_FILE),
                             map_location="cpu", weights_only=True)
        kind, tensors = payload["kind"], payload["tensors"]
        if template is not None:
            want = state_tensors(template)
            got = {k: (tuple(t.shape), t.dtype) for k, t in tensors.items()}
            need = {k: (tuple(t.shape), t.dtype) for k, t in want.items()}
            if kind != type(template).__name__ or got != need:
                raise LayoutMismatch(
                    f"checkpoint step {step} holds a {kind} of {got}; the "
                    f"template is a {type(template).__name__} of {need}")
            tensors = {k: t.to(want[k].device) for k, t in tensors.items()}
        extra = {}
        extra_path = os.path.join(path, EXTRA_FILE)
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra = json.load(f)
        return _build(kind, tensors), extra

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The saved steps, ascending (a save in flight is not one yet)."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit())

    def wait(self) -> None:
        """Block until the pending save is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
