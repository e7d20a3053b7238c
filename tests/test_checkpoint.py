"""Checkpoint round-trips: native format + reference-layout interop."""

import numpy as np

from poccala_tpu.io.corpus import UnitInventory
from poccala_tpu.train import checkpoint as ckpt

from .test_senone_topology import make_bank


FIELDS = ("means", "log_var", "log_w", "log_A", "log_pi", "mix_counts")


class TestNativeCheckpoint:
    def test_roundtrip(self, rng, tmp_path):
        _, bank = make_bank(rng)
        man = {"round": 3, "mode": 2, "mix_level": 2}
        ckpt.save_checkpoint(str(tmp_path / "ck"), bank, man,
                             units=["a", "b", "c", "d"])
        bank2, man2 = ckpt.load_checkpoint(str(tmp_path / "ck"))
        for f in FIELDS:
            assert np.array_equal(
                np.asarray(getattr(bank, f)), np.asarray(getattr(bank2, f))
            ), f
        assert man2["round"] == 3 and man2["units"] == ["a", "b", "c", "d"]

    def test_missing_checkpoint_raises(self, tmp_path):
        import pytest
        from poccala_tpu.utils.errors import ParameterFileError

        with pytest.raises(ParameterFileError):
            ckpt.load_checkpoint(str(tmp_path / "nope"))


class TestShardedCheckpoint:
    """Sharded banks: npz from one process, orbax across processes
    (BASELINE config 4/5: banks larger than one card's memory must never
    materialize whole on a host)."""

    def _sharded_world(self, rng):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from poccala_tpu.parallel import mesh as pmesh

        mesh = pmesh.make_mesh(data_axis=2, state_axis=4,
                               devices=jax.devices()[:8])
        _, bank = make_bank(rng, num_units=8)
        bank, _ = pmesh.pad_bank_states(bank, 4)
        bank = pmesh.shard_bank_states(bank, mesh)
        shardings = {
            f: NamedSharding(mesh, P("state"))
            for f in ("means", "log_var", "log_w", "mix_counts")
        }
        shardings.update({
            f: NamedSharding(mesh, P())
            for f in ("log_A", "log_pi", "senone_map")
        })
        return mesh, bank, shardings

    def test_sharded_auto_roundtrip(self, rng, tmp_path):
        """A bank sharded over one process's devices auto-selects the
        npz format (orbax is for multi-process runs); values round-trip
        exactly."""
        import os

        _, bank, shardings = self._sharded_world(rng)
        path = str(tmp_path / "ck")
        ckpt.save_checkpoint(path, bank, {"round": 1})
        assert os.path.exists(os.path.join(path, "bank.npz"))
        assert not os.path.isdir(os.path.join(path, "bank_orbax"))
        bank2, man = ckpt.load_checkpoint(path)
        assert man["format"] == "npz" and man["round"] == 1
        for f in FIELDS:
            assert np.array_equal(
                np.asarray(getattr(bank, f)), np.asarray(getattr(bank2, f))
            ), f

    def test_sharded_npz_needs_no_orbax(self, rng, tmp_path, monkeypatch):
        """Save and load of a bank sharded over the 8 virtual devices
        never imports orbax, and loading onto a sharding lays the rows
        out per device."""
        import sys

        _, bank, shardings = self._sharded_world(rng)
        monkeypatch.setitem(sys.modules, "orbax", None)
        monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
        path = str(tmp_path / "ck")
        ckpt.save_checkpoint(path, bank, {"round": 2})
        bank2, man = ckpt.load_checkpoint(path, sharding=shardings)
        assert man["format"] == "npz"
        shard = bank2.means.addressable_shards[0].data
        assert shard.shape[0] * 4 == bank.means.shape[0]
        for f in FIELDS:
            assert np.array_equal(
                np.asarray(getattr(bank, f)), np.asarray(getattr(bank2, f))
            ), f

    def test_restore_onto_sharding(self, rng, tmp_path):
        """Restoring with a target sharding yields arrays already laid
        out per-device (S/4 senone rows per state shard) — no host-side
        full-bank gather."""
        _, bank, shardings = self._sharded_world(rng)
        path = str(tmp_path / "ck")
        ckpt.save_checkpoint(path, bank, sharded=True)
        bank2, _ = ckpt.load_checkpoint(path, sharding=shardings)
        s = bank2.means.shape[0]
        shard_rows = bank2.means.addressable_shards[0].data.shape[0]
        assert shard_rows * 4 == s, (shard_rows, s)
        assert np.array_equal(np.asarray(bank.means), np.asarray(bank2.means))

    def test_async_save(self, rng, tmp_path):
        _, bank, _ = self._sharded_world(rng)
        path = str(tmp_path / "ck")
        ckpt.save_checkpoint(path, bank, sharded=True, async_save=True)
        ckpt.wait_for_save()
        bank2, _ = ckpt.load_checkpoint(path)
        assert np.array_equal(np.asarray(bank.means), np.asarray(bank2.means))

    def test_overwrite_existing_sharded(self, rng, tmp_path):
        """Round-boundary checkpointing overwrites in place (the
        reference's per-round parameter store semantics)."""
        import dataclasses

        import jax.numpy as jnp

        _, bank, _ = self._sharded_world(rng)
        path = str(tmp_path / "ck")
        ckpt.save_checkpoint(path, bank, {"round": 1}, sharded=True)
        bank_b = dataclasses.replace(bank, means=bank.means + 1.0)
        ckpt.save_checkpoint(path, bank_b, {"round": 2}, sharded=True)
        bank2, man = ckpt.load_checkpoint(path)
        assert man["round"] == 2
        assert np.allclose(np.asarray(bank2.means),
                           np.asarray(bank.means) + 1.0)


class TestReferenceLayout:
    def test_export_import_roundtrip(self, rng, tmp_path):
        cfg, bank = make_bank(rng, num_units=3, state_num=5, mix=2,
                              max_mix=3, dim=4)
        inv = UnitInventory(["x", "y", "z"])
        root = str(tmp_path / "params")
        ckpt.export_reference_layout(root, bank, inv, unit_type="TEST")
        # the reference directory shape exists
        import os
        assert os.path.exists(root + "/TEST/y/HMM/transmat.npy")
        assert os.path.exists(root + "/TEST/z/GMM_2/GMM_covariance.npy")
        assert os.path.exists(root + "/TEST/x/GMM_0/GMM_config.ini")

        bank2 = ckpt.import_reference_layout(
            root, inv, "TEST", state_num=5, max_mix=3
        )
        m = np.asarray(bank.mix_counts)
        for s in range(bank.num_states):
            k = int(m[s])
            assert np.allclose(
                np.asarray(bank.means)[s, :k], np.asarray(bank2.means)[s, :k],
                atol=1e-6,
            )
            assert np.allclose(
                np.asarray(bank.log_var)[s, :k],
                np.asarray(bank2.log_var)[s, :k], atol=1e-5,
            )
            assert np.allclose(
                np.exp(np.asarray(bank.log_w))[s, :k],
                np.exp(np.asarray(bank2.log_w))[s, :k], atol=1e-6,
            )
        assert np.allclose(
            np.exp(np.asarray(bank.log_A)), np.exp(np.asarray(bank2.log_A)),
            atol=1e-6,
        )
        assert np.array_equal(np.asarray(bank.mix_counts),
                              np.asarray(bank2.mix_counts))
