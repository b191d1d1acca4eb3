"""Checkpoint and resume for long photon runs.

The complete state of a photon run between batches is small and exact:
the tallies, the seed and the number of finished batches.  Between chunks
of the kernel engine (``ops/photon_kernel.simulate_kernel``) it is the
nine ``KernelState`` arrays, the tallies, the per-tile launch quota, the
next block index and the seed.  Snapshots are plain ``.npz`` files
written atomically (a tmp file, then ``os.replace``), so a crash in the
middle of a save leaves the previous snapshot whole.

``load_tallies`` also reads the files the JAX package's ``save_tallies``
writes: there ``launched`` and ``steps`` are two-word ``(hi, lo)``
float32 counters, carried across by ``interop.tallies_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from light_transport_tpu_torch.core.config import PhotonRunConfig
from light_transport_tpu_torch.ops.photon_kernel import KernelState
from light_transport_tpu_torch.tally.tallies import PhotonTallies
from light_transport_tpu_torch.utils import interop

_TALLY_KEYS = [f.name for f in dataclasses.fields(PhotonTallies)]


def _norm(path: str) -> str:
    """``np.savez`` appends ``.npz`` to a suffix-less path; normalise it up
    front so save, load and the resume's existence check agree on one
    file."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def write_snapshot(path: str, arrays: dict) -> None:
    """Write ``arrays`` to ``path`` (``.npz`` appended when missing)
    atomically: a crash mid-save leaves the old file."""
    path = _norm(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def _tallies_from(z, prefix: str, device) -> PhotonTallies:
    d = {k: z[prefix + k] for k in _TALLY_KEYS}
    if d["launched"].shape == (2,):  # the JAX package's two-word counters
        return interop.tallies_from_numpy(d, device)
    return PhotonTallies(**{k: _tensor(v, device) for k, v in d.items()})


def save_tallies(path: str, tallies: PhotonTallies, seed: int,
                 batches_done: int) -> None:
    """Snapshot ``tallies`` with the run's seed and finished batches."""
    arrays = {k: _host(getattr(tallies, k)) for k in _TALLY_KEYS}
    write_snapshot(path, dict(arrays, seed=np.asarray(seed),
                              batches_done=np.asarray(batches_done)))


def load_tallies(path: str, device=None) -> Tuple[PhotonTallies, int, int]:
    """``(tallies, seed, batches_done)`` from a file of ``save_tallies``,
    this package's or the JAX package's, on ``device`` (the card unless
    given)."""
    with np.load(_norm(path)) as z:
        return (_tallies_from(z, "", _device(device)), int(z["seed"]),
                int(z["batches_done"]))


def accumulate(a: PhotonTallies, b: PhotonTallies) -> PhotonTallies:
    """Merge two tally partials; the int64 counters stay exact at any
    count."""
    return a.merge(b)


def batch_seed(seed: int, batch: int) -> int:
    """The 31-bit seed of batch ``batch`` of a resumable run, mixed from
    ``(seed, batch)`` (the part ``jax.random.fold_in`` plays in the JAX
    package): a resumed batch draws what it would have drawn unbroken."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF,
                                    int(batch)]).generate_state(1)
    return int(state[0]) & 0x7FFFFFFF


def simulate_resumable(medium, cfg: PhotonRunConfig, seed: int,
                       checkpoint_path: str, n_batches: int = 10,
                       lanes: int = 16384) -> PhotonTallies:
    """Run ``cfg.n_photons`` split into ``n_batches`` through the superstep
    engine, snapshotting the summed tallies after each batch.

    Re-invoked with the same arguments, the run resumes after the last
    finished batch and returns bitwise the tallies of an unbroken run.  A
    snapshot of another seed is ignored and the run starts over."""
    from light_transport_tpu_torch.transport.photon import simulate_photons

    if n_batches < 1 or cfg.n_photons < n_batches:
        raise ValueError(f"n_batches={n_batches} must lie in [1, "
                         f"n_photons={cfg.n_photons}]")
    per_batch = cfg.n_photons // n_batches
    extra = cfg.n_photons - per_batch * n_batches
    start = 0
    total: Optional[PhotonTallies] = None
    if os.path.exists(_norm(checkpoint_path)):
        total, saved_seed, start = load_tallies(checkpoint_path,
                                                medium.device)
        if saved_seed != seed:
            total, start = None, 0
    for b in range(start, n_batches):
        n_b = per_batch + (extra if b == 0 else 0)
        part = simulate_photons(medium,
                                dataclasses.replace(cfg, n_photons=n_b),
                                batch_seed(seed, b), lanes=lanes)
        total = part if total is None else accumulate(total, part)
        save_tallies(checkpoint_path, total, seed, b + 1)
    return total


# --------------------------------------------------------------------------
# kernel-engine checkpoints
# --------------------------------------------------------------------------

def kernel_snapshot(state: KernelState, tallies: PhotonTallies,
                    quota: torch.Tensor, next_block: int, seed: int,
                    fingerprint: str) -> dict:
    """The host arrays of a kernel-engine snapshot (the device-to-host
    copy of :func:`save_kernel_checkpoint`)."""
    arrays = {"state_" + k: _host(t) for k, t in zip(KernelState._fields,
                                                     state)}
    arrays.update({"tally_" + k: _host(getattr(tallies, k))
                   for k in _TALLY_KEYS})
    arrays.update(quota=_host(quota), next_block=np.asarray(next_block),
                  seed=np.asarray(seed), fingerprint=np.asarray(fingerprint))
    return arrays


def save_kernel_checkpoint(path: str, state: KernelState,
                           tallies: PhotonTallies, quota: torch.Tensor,
                           next_block: int, seed: int,
                           fingerprint: str) -> None:
    """Atomically snapshot a kernel-engine run after a finished chunk."""
    write_snapshot(path, kernel_snapshot(state, tallies, quota, next_block,
                                         seed, fingerprint))


def load_kernel_checkpoint(path: str, fingerprint: str, device=None):
    """``(state, tallies, quota, next_block)`` from a kernel-engine
    snapshot on ``device`` (the card unless given), or None when the file
    is absent or was written by a run of another fingerprint (the
    arguments that must match for the resumed streams and shapes to line
    up)."""
    path = _norm(path)
    if not os.path.exists(path):
        return None
    device = _device(device)
    with np.load(path) as z:
        if str(z["fingerprint"]) != fingerprint:
            return None
        state = KernelState(*(_tensor(z["state_" + k], device)
                              for k in KernelState._fields))
        return (state, _tallies_from(z, "tally_", device),
                _tensor(z["quota"], device), int(z["next_block"]))
