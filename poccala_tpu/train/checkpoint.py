"""Checkpoint / resume.

Replaces the reference's filesystem parameter store — one directory per
unit holding ``HMM/transmat.npy``, ``HMM/pi.npy``, ``HMM/HMM_config.ini``
and per-state ``GMM_<k>/{GMM_means,GMM_covariance,GMM_weight}.npy`` +
``GMM_config.ini`` (``LHMM.py:192-254``, ``Clustering.py:234-312``) plus
the ``trainInfo_<job>.csv`` resume ledger (``AcousticModel.py:311-329``)
— with:

* a single checkpoint of the senone-bank pytree — ``.npz`` whenever one
  process drives every device (a bank sharded over the cards of one
  host is fully addressable and is written from its gathered arrays),
  and **orbax** only for multi-process runs (``jax.process_count() >
  1``), where each process writes only its addressable shards and
  :func:`load_checkpoint` can restore straight onto a target sharding
  without materializing the full bank on any host — and
* a JSON manifest carrying the training phase/round/mixture level, which
  subsumes the unit-granular trainInfo resume: bank updates are atomic
  per round, so resume restarts at the round boundary (SURVEY.md §5
  "checkpoint/resume").

Interop: :func:`export_reference_layout` / :func:`import_reference_layout`
read and write the reference's per-unit directory format so parameters
can move between the two systems.
"""

from __future__ import annotations

import configparser
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from poccala_tpu.io.corpus import UnitInventory
from poccala_tpu.models.senone_bank import SenoneBank
from poccala_tpu.utils.errors import ParameterFileError
from poccala_tpu.utils.logmath import masked_log

_FIELDS = ("means", "log_var", "log_w", "log_A", "log_pi", "mix_counts",
           "senone_map")
_DTYPES = {"mix_counts": np.int32, "senone_map": np.int32}


def _sync(name: str) -> None:
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def save_checkpoint(path: str, bank: SenoneBank, manifest: dict | None = None,
                    units: list[str] | None = None,
                    sharded: bool | None = None,
                    async_save: bool = False) -> None:
    """Write the bank + ``manifest.json`` under ``path``.

    :param sharded: force the orbax sharded format; default (None)
        selects it only for multi-process runs — each process then
        writes only its addressable shards.  Otherwise a plain
        ``bank.npz`` (from the gathered arrays when the bank is sharded
        over this process's devices).
    :param async_save: with the orbax format, return as soon as the
        on-device data is snapshotted and commit in a background thread
        (training continues during the write).
    """
    import jax

    if sharded is None:
        sharded = jax.process_count() > 1
    proc0 = jax.process_index() == 0
    if proc0:
        os.makedirs(path, exist_ok=True)
    _sync("poccala-ckpt-mkdir")

    if sharded:
        import orbax.checkpoint as ocp

        bank_dir = os.path.join(os.path.abspath(path), "bank_orbax")
        if proc0 and os.path.isdir(bank_dir):
            import shutil

            shutil.rmtree(bank_dir)
        _sync("poccala-ckpt-clean")
        arrays = {f: getattr(bank, f) for f in _FIELDS}
        if jax.process_count() > 1:
            arrays = _globalize(arrays)
        if async_save:
            ckptr = _async_checkpointer()
            ckptr.save(bank_dir, args=ocp.args.StandardSave(arrays))
        else:
            with ocp.StandardCheckpointer() as ckptr:
                ckptr.save(bank_dir, arrays)
        shapes = {f: list(getattr(bank, f).shape) for f in _FIELDS}
    else:
        arrays = {f: np.asarray(getattr(bank, f)) for f in _FIELDS}
        np.savez(os.path.join(path, "bank.npz"), **arrays)
        shapes = {f: list(arrays[f].shape) for f in _FIELDS}

    if proc0:
        man = dict(manifest or {})
        if units is not None:
            man["units"] = units
        man["shapes"] = shapes
        man["format"] = "orbax" if sharded else "npz"
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(man, f, indent=2)
    _sync("poccala-ckpt-manifest")


def _globalize(arrays: dict) -> dict:
    """Multi-host: orbax can only serialize *global* arrays.  Leaves
    that are still host-local (e.g. small tables never device_put onto
    the mesh) are lifted to globally-replicated arrays on the mesh of
    any already-global leaf."""
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = None
    for a in arrays.values():
        if isinstance(a, jax.Array) and isinstance(a.sharding, NamedSharding):
            if not a.is_fully_addressable:
                mesh = a.sharding.mesh
                break
    out = {}
    for f, a in arrays.items():
        if isinstance(a, jax.Array) and not a.is_fully_addressable:
            out[f] = a
        elif mesh is not None:
            out[f] = multihost_utils.host_local_array_to_global_array(
                np.asarray(a), mesh, PartitionSpec()
            )
        else:
            out[f] = a
    return out


_ASYNC_CKPTR = None


def _async_checkpointer():
    """Process-wide async checkpointer (owns the background commit
    thread; reusing it lets :func:`wait_for_save` find pending work)."""
    global _ASYNC_CKPTR
    if _ASYNC_CKPTR is None:
        import orbax.checkpoint as ocp

        _ASYNC_CKPTR = ocp.AsyncCheckpointer(ocp.StandardCheckpointHandler())
    return _ASYNC_CKPTR


def wait_for_save() -> None:
    """Block until any in-flight :func:`save_checkpoint`
    (``async_save=True``) has committed."""
    if _ASYNC_CKPTR is not None:
        _ASYNC_CKPTR.wait_until_finished()


def load_checkpoint(path: str, sharding=None) -> tuple[SenoneBank, dict]:
    """Load a checkpoint directory -> (bank, manifest).

    :param sharding: optional pytree-or-single ``jax.sharding.Sharding``
        — orbax leaves are restored **directly onto the target
        sharding** (each process reads only the shards it will hold; the
        full bank never materializes on one host); npz leaves are placed
        onto it after loading.
    """
    manifest = {}
    man_path = os.path.join(path, "manifest.json")
    if os.path.exists(man_path):
        with open(man_path) as f:
            manifest = json.load(f)

    bank_dir = os.path.join(os.path.abspath(path), "bank_orbax")
    npz_path = os.path.join(path, "bank.npz")
    if os.path.isdir(bank_dir):
        import jax
        import orbax.checkpoint as ocp

        wait_for_save()
        with ocp.StandardCheckpointer() as ckptr:
            if sharding is not None:
                shapes = manifest["shapes"]
                target = {
                    f: jax.ShapeDtypeStruct(
                        tuple(shapes[f]),
                        _DTYPES.get(f, np.float32),
                        sharding=(sharding[f] if isinstance(sharding, dict)
                                  else sharding),
                    )
                    for f in _FIELDS
                }
                data = ckptr.restore(bank_dir, target)
            else:
                data = ckptr.restore(bank_dir)
        bank = SenoneBank(**{f: jnp.asarray(data[f]) for f in _FIELDS})
    elif os.path.exists(npz_path):
        import jax

        data = np.load(npz_path)
        if sharding is None:
            bank = SenoneBank(**{f: jnp.asarray(data[f]) for f in _FIELDS})
        else:
            bank = SenoneBank(**{
                f: jax.device_put(data[f], sharding[f] if isinstance(
                    sharding, dict) else sharding)
                for f in _FIELDS})
    else:
        raise ParameterFileError(f"no checkpoint at {path}")
    return bank, manifest


# ----------------------------------------------------------------------
# Reference-layout interop
# ----------------------------------------------------------------------

def export_reference_layout(root: str, bank: SenoneBank,
                            inventory: UnitInventory,
                            unit_type: str = "XIF_tone",
                            fix_code: int = 0) -> None:
    """Write the reference's per-unit parameter directories
    (``PARAMETERS_FILE_PATH/<unit_type>/<unit>/...``,
    ``LHMM.save_parameter`` ``LHMM.py:192-209``, ``GMM.save_parameter``
    ``Clustering.py:234-255``)."""
    base = os.path.join(root, unit_type)
    os.makedirs(base, exist_ok=True)
    n = bank.state_num
    emit = bank.emit_states
    means = np.asarray(bank.means)
    var = np.exp(np.asarray(bank.log_var))
    w = np.exp(np.asarray(bank.log_w))
    log_a = np.asarray(bank.log_A)
    pi = np.exp(np.asarray(bank.log_pi))
    mix_counts = np.asarray(bank.mix_counts)
    senone_map = np.asarray(bank.senone_map)

    for u, unit in enumerate(inventory.units):
        unit_dir = os.path.join(base, unit)
        hmm_dir = os.path.join(unit_dir, "HMM")
        os.makedirs(hmm_dir, exist_ok=True)
        np.save(os.path.join(hmm_dir, "transmat.npy"), np.exp(log_a[u]))
        np.save(os.path.join(hmm_dir, "pi.npy"), pi[u])
        cp = configparser.ConfigParser()
        cp.add_section("Configuration")
        cp.set("Configuration", "FIX_CODE", str(fix_code))
        with open(os.path.join(hmm_dir, "HMM_config.ini"), "w") as f:
            cp.write(f)
        for e in range(emit):
            s = int(senone_map[u, e])  # tied states export shared params
            m_act = int(mix_counts[s])
            gmm_dir = os.path.join(unit_dir, f"GMM_{e}")
            os.makedirs(gmm_dir, exist_ok=True)
            np.save(os.path.join(gmm_dir, "GMM_means.npy"), means[s, :m_act])
            cov = np.stack([np.diag(var[s, mi]) for mi in range(m_act)])
            np.save(os.path.join(gmm_dir, "GMM_covariance.npy"), cov)
            np.save(os.path.join(gmm_dir, "GMM_weight.npy"), w[s, :m_act])
            cp = configparser.ConfigParser()
            cp.add_section("Configuration")
            cp.set("Configuration", "MIXTURE", str(m_act))
            cp.set("Configuration", "DIMENSION", str(bank.dim))
            cp.set("Configuration", "BIAS", "100.0")
            with open(os.path.join(gmm_dir, "GMM_config.ini"), "w") as f:
                cp.write(f)


def import_reference_layout(root: str, inventory: UnitInventory,
                            unit_type: str, state_num: int,
                            max_mix: int) -> SenoneBank:
    """Load a reference-format parameter store into a bank
    (``AcousticModel.init_parameter``, ``AcousticModel.py:228-240``)."""
    base = os.path.join(root, unit_type)
    emit = state_num - 2
    u_total = len(inventory)
    first = None
    banks = {}
    for u, unit in enumerate(inventory.units):
        unit_dir = os.path.join(base, unit)
        if not os.path.isdir(unit_dir):
            raise ParameterFileError(f"missing unit directory: {unit_dir}")
        transmat = np.load(os.path.join(unit_dir, "HMM", "transmat.npy"))
        pi = np.load(os.path.join(unit_dir, "HMM", "pi.npy"))
        gmms = []
        for e in range(emit):
            gmm_dir = os.path.join(unit_dir, f"GMM_{e}")
            mu = np.load(os.path.join(gmm_dir, "GMM_means.npy"))
            cov = np.load(os.path.join(gmm_dir, "GMM_covariance.npy"))
            wt = np.load(os.path.join(gmm_dir, "GMM_weight.npy"))
            cov = np.squeeze(cov)
            if cov.ndim == 2:  # single mixture [D, D]
                cov = cov[None]
            var = np.stack([np.diag(c) for c in cov])
            gmms.append((mu, var, wt))
            if first is None:
                first = mu.shape[-1]
        banks[u] = (transmat, pi, gmms)

    d = first
    s_total = u_total * emit
    means = np.zeros((s_total, max_mix, d), np.float32)
    var = np.ones((s_total, max_mix, d), np.float32)
    w = np.zeros((s_total, max_mix), np.float32)
    mix_counts = np.zeros((s_total,), np.int32)
    log_a = np.zeros((u_total, state_num, state_num), np.float32)
    pi_all = np.zeros((u_total, state_num), np.float32)
    for u in range(u_total):
        transmat, pi, gmms = banks[u]
        with np.errstate(divide="ignore"):
            log_a[u] = np.where(transmat > 0, np.log(np.maximum(transmat, 1e-300)), -1e30)
        pi_all[u] = pi
        for e, (mu, v, wt) in enumerate(gmms):
            s = u * emit + e
            m_act = len(wt)
            means[s, :m_act] = mu
            var[s, :m_act] = np.maximum(v, 1e-10)
            w[s, :m_act] = wt
            mix_counts[s] = m_act
    from poccala_tpu.models.senone_bank import identity_senone_map

    return SenoneBank(
        means=jnp.asarray(means),
        log_var=jnp.asarray(np.log(var)),
        log_w=masked_log(jnp.asarray(w)),
        log_A=jnp.asarray(log_a),
        log_pi=masked_log(jnp.asarray(np.maximum(pi_all, 0.0))),
        mix_counts=jnp.asarray(mix_counts),
        senone_map=identity_senone_map(u_total, emit),
    )
