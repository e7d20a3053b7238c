"""Worker process for the multi-host E-step / checkpoint tests (run via
subprocess).

Usage: python multihost_worker.py <process_id> <num_processes> <out_json>
           [estep|ckpt] [shared_dir]
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def synth(rng, num_units, emit, dim, b, t, max_l):
    labels = rng.integers(0, num_units, size=(b, max_l)).astype(np.int32)
    lens = rng.integers(1, max_l + 1, size=(b,)).astype(np.int32)
    xs = rng.normal(size=(b, t, dim)).astype(np.float32)
    masks = np.ones((b, t), bool)
    return labels, lens, xs, masks


def ckpt_roundtrip(pid: int, nproc: int, shared_dir: str) -> dict:
    """Multi-host sharded checkpoint round-trip: every process writes
    only its addressable shards; restore lands straight on the target
    sharding (each process reads only its rows)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from poccala_tpu.config import ModelConfig
    from poccala_tpu.models import senone_bank as sb
    from poccala_tpu.parallel import mesh as pmesh
    from poccala_tpu.train import checkpoint as ckpt

    cfg = ModelConfig(state_num=5, mix_level=2, max_mix_level=2)
    bank = sb.create_bank(8, cfg, 6, key=jax.random.PRNGKey(2))
    state_axis = 2
    mesh = pmesh.make_mesh(
        data_axis=jax.device_count() // state_axis, state_axis=state_axis
    )
    bank, _ = pmesh.pad_bank_states(bank, state_axis)
    bank = pmesh.shard_bank_states(bank, mesh)

    path = os.path.join(shared_dir, "mh_ckpt")
    ckpt.save_checkpoint(path, bank, {"round": 7})
    shardings = {
        f: NamedSharding(mesh, P("state"))
        for f in ("means", "log_var", "log_w", "mix_counts")
    }
    shardings.update({
        f: NamedSharding(mesh, P())
        for f in ("log_A", "log_pi", "senone_map")
    })
    bank2, man = ckpt.load_checkpoint(path, sharding=shardings)
    local_rows = bank2.means.addressable_shards[0].data.shape[0]
    # global arrays are not fully addressable per process: checksums go
    # through jit (computation follows the sharding; the scalar result
    # replicates to every host)
    checksum = jax.jit(lambda a: jnp.abs(a).sum())
    return {
        "format": man["format"],
        "round": man["round"],
        "global_devices": jax.device_count(),
        "means_checksum": float(checksum(bank.means)),
        "restored_checksum": float(checksum(bank2.means)),
        "shard_rows": int(local_rows),
        "total_rows": int(bank2.means.shape[0]),
        "state_axis": state_axis,
    }


def decode_mode(pid: int, nproc: int) -> dict:
    """Distributed beam decode across process boundaries (BASELINE
    config 5, N ≥ 2 hosts): every process contributes its utterance
    slice, the sharded decode program runs on the global mesh, and
    replicated jit-reductions summarize the global n-best — values must
    match the single-process run."""
    from poccala_tpu.parallel import decode as pdecode
    from poccala_tpu.parallel import mesh as pmesh

    dec, utt = pdecode._toy_world()  # seed 0: identical on every process
    mesh = pmesh.make_mesh(data_axis=jax.device_count(), state_axis=1)
    global_b = 16  # same utterances whether 4 (1-proc) or 8 devices
    plans = [[0, 1, 2, 3], [4, 5], [0, 1], [4, 5, 0, 1]]
    t_max = 48
    feats = np.zeros((global_b, t_max, 8), np.float32)
    nf = np.zeros((global_b,), np.int32)
    for i in range(global_b):
        x = utt(plans[i % len(plans)])
        feats[i, : len(x)] = x
        nf[i] = len(x)
    if nproc > 1:
        local = slice(pid * (global_b // nproc),
                      (pid + 1) * (global_b // nproc))
        f_g, n_g = pmesh.distribute_batch(
            mesh, (feats[local], nf[local]), global_b
        )
    else:
        f_g, n_g = jnp.asarray(feats), jnp.asarray(nf)
    seqs, scores = pdecode.decode_sharded_global(dec, f_g, n_g, mesh)
    best = jax.jit(lambda a: jnp.where(a[:, 0] > -1e29, a[:, 0], 0.0).sum())
    words = jax.jit(lambda s: (s[:, 0] >= 0).sum())
    return {
        "best_scores_sum": float(best(scores)),
        "best_word_count": int(words(seqs)),
        "global_devices": jax.device_count(),
        "global_batch": global_b,
    }


def main():
    pid, nproc, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "estep"
    if nproc > 1:
        jax.distributed.initialize(
            "localhost:12757", num_processes=nproc, process_id=pid
        )

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if mode == "ckpt":
        result = ckpt_roundtrip(pid, nproc, sys.argv[5])
        with open(out_path, "w") as f:
            json.dump(result, f)
        return
    if mode == "decode":
        result = decode_mode(pid, nproc)
        with open(out_path, "w") as f:
            json.dump(result, f)
        return
    from poccala_tpu.config import ModelConfig
    from poccala_tpu.models import senone_bank as sb
    from poccala_tpu.parallel import mesh as pmesh

    cfg = ModelConfig(state_num=5, mix_level=2, max_mix_level=2)
    bank = sb.create_bank(3, cfg, 5, key=jax.random.PRNGKey(1))

    rng = np.random.default_rng(0)
    global_b, t, max_l = 8, 12, 3
    labels, lens, xs, masks = synth(rng, 3, 3, 5, global_b, t, max_l)

    mesh = pmesh.make_mesh(data_axis=len(jax.devices()), state_axis=1)
    estep = pmesh.make_parallel_estep(mesh, cfg.state_num, max_l)
    if nproc > 1:
        local = slice(pid * (global_b // nproc), (pid + 1) * (global_b // nproc))
        arrays = pmesh.distribute_batch(
            mesh, (labels[local], lens[local], xs[local], masks[local]),
            global_b,
        )
        bank = pmesh.replicate_bank(bank, mesh)
    else:
        arrays = tuple(jnp.asarray(a) for a in (labels, lens, xs, masks))
        bank = pmesh.replicate_bank(bank, mesh)
    stats, _ = estep(bank, *arrays)

    result = {
        "loglik": float(stats.loglik),
        "occ_sum": float(np.asarray(stats.occ).sum()),
        "trans_sum": float(np.asarray(stats.trans).sum()),
        "cx_checksum": float(np.abs(np.asarray(stats.cx)).sum()),
        "n_utts": float(stats.n_utts),
        "global_devices": jax.device_count(),
    }
    with open(out_path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
