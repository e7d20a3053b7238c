"""Fully on-device decoder: dense graph Viterbi over the lexicon tree.

Third tier of the decoder stack (dict reference → vectorized host →
device).  Earlier rounds ran a token machine (fixed-capacity token
arrays + per-frame sort/dedup/top-k) mirroring the host tiers; profiling
showed the per-frame pool machinery (concats, gathers, a [P]-wide sort)
dominated decode time while the arrays involved were tiny (measured on
the previous accelerator).  This version replaces tokens with a
dense form: **every lexicon node is always live**, and the
per-frame update is a handful of fused elementwise/gather ops over
``[n_nodes, Ns]`` arrays — no sort, no top-k, no dynamic pool, and no
beam approximation at all (the search is exact Viterbi over the
lexicon-tree HMM; ``beam``/``max_tokens``/``candidate``/``emit_top`` are
accepted for API compatibility but the device tier no longer prunes).

Per frame, batched over utterances with ``vmap``:

1. **in-node advance**: one banded max-plus step over all nodes at once
   against the precomputed ``[T, S]`` senone score matrix, with the
   winning source state tracked so per-state word history and LM context
   propagate along the Viterbi path (``Token.viterbi``'s inner loop,
   ``Decoder.py:250-288``, dense over the whole tree);
2. **exit flow**: each node's exit score moves to its (unique, it's a
   tree) children's entry states — one gather via the parent array
   (``passing_in_word``, ``Decoder.py:114-143``);
3. **word boundary**: the frame's best word emission applies its bigram
   LM score and re-enters every first-level node; the emission writes
   one ``(prev_ptr, word)`` traceback-lattice row per frame (the
   ``passing_between_word`` the reference left unimplemented,
   ``Decoder.py:146-156``).  Lesser same-frame emissions are not lost:
   their word-end nodes stay live and re-enter on a later frame if they
   dominate then — with no LM this single-best re-entry is exact for the
   1-best path; with an N-gram LM it is the standard word-level Viterbi
   approximation (one ``(history, LM state)`` per node state; the LM is
   applied to the top-16 acoustic emissions of each frame, which is
   likewise exact in the no-LM case since adding zero preserves the
   argmax).

The final n-best (word ids + scores) is also extracted **on device**
(exit scores → per-(node, word) emission matrix → top-k → pointer-chase
backtrace as a short ``lax.scan``), so the host only maps ids to vocab
strings — no per-token Python on any path.

Distributed decode (BASELINE config 5): ``decode_batch(..., mesh=...)``
runs scoring + scan + finalize under ``shard_map`` with utterances
sharded over the ``data`` mesh axis and tables/bank replicated; decode
is embarrassingly parallel per utterance, so the shard program contains
no collectives (the reference's intended serving path, ``Decoder.py:
91-167``, scaled out).
"""

from __future__ import annotations

import numpy as np

from dataclasses import dataclass, field

from poccala_tpu.decoder.beam import Hypothesis
from poccala_tpu.decoder.vector import VectorBeamDecoder
from poccala_tpu.utils.logmath import NEG_INF


@dataclass
class _StreamState:
    """Carry of an online decode session (see
    :meth:`DeviceBeamDecoder.stream_init`)."""

    batch: int
    max_frames: int
    t_offset: int = 0
    carry: tuple | None = None
    tb_prev: list = field(default_factory=list)
    tb_word: list = field(default_factory=list)


class DeviceBeamDecoder(VectorBeamDecoder):
    """Dense on-device graph-Viterbi decoder.  Constructor matches
    :class:`poccala_tpu.decoder.beam.BeamDecoder`; ``max_words`` bounds
    the backtrace length of a single hypothesis."""

    def __init__(self, *args, emit_top: int = 4, max_words: int = 64,
                 block_size: int = 1024, active_blocks: int | None = None,
                 prune_hysteresis: float = 0.0,
                 **kwargs):
        """``active_blocks``: enable block-pruned search — per frame
        only the ``active_blocks`` highest-scoring blocks of
        ``block_size`` (DFS-contiguous) nodes run the banded advance;
        the rest are pruned to log-zero and revive only through word
        re-entry / parent flow (entry bookkeeping stays global and
        cheap).  ``None`` (default) keeps the exact dense search.  This
        is the block form of the reference's beam pruning
        (``Decoder.py:34``, keep-fraction beam): per-frame cost becomes
        ~O(active_blocks·block_size) instead of O(n_nodes) for the
        dominant [*, Ns]-array work — for 10⁴–10⁵-node lexicons.

        ``prune_hysteresis``: log-score bonus (nats) added to the
        currently-active blocks in the per-frame block selection (a
        challenger must beat an active block by the margin to displace
        it).  Tested against the trained-bank pruning collapse
        (record in commit a016147: (256, 8) costs +58pp at the
        37.5k-word table) and MEASURED NEGATIVE (same record: +1-2pp
        WER over the
        non-sticky selection at every width) — the collapse is genuine
        width starvation; widening ``active_blocks`` is what recovers
        accuracy.  Default 0 (off)."""
        super().__init__(*args, **kwargs)
        self.emit_top = max(1, int(emit_top))  # accepted; no longer used
        self.max_words = max(2, int(max_words))
        self.block_size = max(8, int(block_size))
        self.active_blocks = (None if active_blocks is None
                              else max(1, int(active_blocks)))
        self.prune_hysteresis = float(prune_hysteresis)

    # ------------------------------------------------------------------
    def _prep_device(self):
        if hasattr(self, "_dev_ready"):
            return
        import jax.numpy as jnp

        self._prep_tables()
        # trim the band table to the widest transition that actually
        # exists: the reference 5-state left-to-right topology only has
        # self-loops and +1 steps (``AcousticModel.init_unit``,
        # ``AcousticModel.py:176-181``), so W shrinks 5 -> 2 and the
        # per-frame band loop halves
        bands = self._bands
        live = np.any(bands > NEG_INF / 2, axis=(0, 1))    # [W]
        w_eff = int(max(2, np.max(np.nonzero(live)[0], initial=1) + 1))
        bands = np.asarray(bands[:, :, :w_eff])            # [N, Ns, W_eff]
        senone = np.asarray(self._senone)
        word_tab = np.asarray(self._word_tab)
        self._n_vocab = len(self._vocab)
        # LM on device: sparse (sorted bigram keys + unigram/backoff
        # vectors) for Ngram-style LMs — full-vocabulary decode with a
        # dense [V+1, V] table would need 5.8 GB at 37.5k words; dense
        # flat only for foreign LM objects; none -> constant penalty
        self._j_lm_sparse = None
        self._j_lm_flat = None
        if self._lm_sparse is not None:
            uni, rboff, cbase, keys, vals = self._lm_sparse
            v = self._n_vocab
            if (v + 1) * v >= 2**31:
                raise ValueError(
                    f"sparse device LM keys overflow int32 at V={v}")
            self._j_lm_sparse = (
                jnp.asarray(uni), jnp.asarray(rboff), jnp.asarray(cbase),
                jnp.asarray(keys.astype(np.int32)), jnp.asarray(vals),
            )
        elif self._lm_tab is not None:
            self._j_lm_flat = jnp.asarray(
                self._lm_tab, jnp.float32).reshape(-1)
        # tree parent of each node; -1 for the virtual root and for
        # first-level nodes (their entry comes from word re-entry only)
        lex = self.lexicon
        n_nodes = lex.n_nodes
        par = np.full((n_nodes,), -1, np.int32)
        for p in range(1, n_nodes):
            for c in lex.children(p):
                par[c] = p
        is_rc = np.zeros((n_nodes,), bool)
        is_rc[np.asarray(self._roots, np.int64)] = True

        # block pruning: DFS-permute so subtrees are block-contiguous
        # (a live word keeps its whole prefix path in few blocks), pad
        # to a block multiple with dead nodes.  The permutation lives
        # entirely in device-table space — traceback rows carry frame
        # pointers + word ids, never node ids, so hypotheses and the
        # host tiers are unaffected.
        self._prune_on = (self.active_blocks is not None
                          and n_nodes > self.block_size)
        self._perm = None  # new -> old node permutation (pruned mode)
        if self._prune_on:
            perm = np.zeros(n_nodes, np.int64)      # new -> old
            pos, stack = 0, [0]
            seen = np.zeros(n_nodes, bool)
            while stack:
                nid = stack.pop()
                if seen[nid]:
                    continue
                seen[nid] = True
                perm[pos] = nid
                pos += 1
                stack.extend(reversed(list(lex.children(nid))))
            assert pos == n_nodes, "lexicon tree has unreachable nodes"
            self._perm = perm
            new_of = np.empty(n_nodes, np.int64)
            new_of[perm] = np.arange(n_nodes)
            bands = bands[perm]
            senone = senone[perm]
            word_tab = word_tab[perm]
            par = np.where(par[perm] >= 0, new_of[np.clip(par[perm], 0,
                                                          None)], -1)
            par = par.astype(np.int32)
            is_rc = is_rc[perm]
            pad = (-n_nodes) % self.block_size
            if pad:
                bands = np.pad(bands, ((0, pad), (0, 0), (0, 0)),
                               constant_values=NEG_INF)
                senone = np.pad(senone, ((0, pad), (0, 0)),
                                constant_values=-1)
                word_tab = np.pad(word_tab, ((0, pad), (0, 0)),
                                  constant_values=-1)
                par = np.pad(par, (0, pad), constant_values=-1)
                is_rc = np.pad(is_rc, (0, pad))
            self._n_blocks = bands.shape[0] // self.block_size
            if self.active_blocks >= self._n_blocks:
                self._prune_on = False  # pruning would be a no-op

        self._j_bands = jnp.asarray(bands)       # [N_p, Ns, W_eff]
        self._j_senone = jnp.asarray(senone)     # [N_p, Ns]
        self._j_word = jnp.asarray(word_tab)     # [N_p, Wt]
        # word-emission slots: the static (node, word) pairs, so
        # emissions are static-index gathers per slot (chosen for the
        # previous accelerator, where dynamic point gathers were slow)
        node_slot, word_slot = np.nonzero(word_tab >= 0)
        if len(node_slot) == 0:
            node_slot, word_slot = np.zeros(1, np.int64), np.zeros(1, np.int64)
        self._j_node_slot = jnp.asarray(node_slot.astype(np.int32))  # [Q]
        self._j_word_slot = jnp.asarray(
            word_tab[node_slot, word_slot].astype(np.int32))         # [Q]
        self._j_slot_valid = jnp.asarray(
            word_tab[node_slot, word_slot] >= 0)                     # [Q]
        self._j_parent = jnp.asarray(par)
        self._j_is_root_child = jnp.asarray(is_rc)
        self._dev_ready = True

    # ------------------------------------------------------------------
    def decode_batch(self, feats, n_frames, return_nbest: int = 1,
                     mesh=None):
        """Decode ``[B, T, D]`` features; returns per-utterance n-best
        :class:`Hypothesis` lists.

        :param feats: host or device array — scoring, the Viterbi scan
            and n-best extraction all run inside one jitted program.
        :param mesh: optional ``jax.sharding.Mesh`` with a ``data`` axis
            — the program then runs under ``shard_map`` with utterances
            sharded across devices (distributed decode).
        """
        return self.decode_collect(
            self.decode_dispatch(feats, n_frames, return_nbest, mesh))

    def decode_dispatch(self, feats, n_frames, return_nbest: int = 1,
                        mesh=None):
        """Asynchronously dispatch one decode batch and return an opaque
        handle; :meth:`decode_collect` turns the handle into hypothesis
        lists.  JAX dispatch returns before the device executes, so a
        server can overlap the host work of the next batch (WAV load,
        frontend padding, id→word mapping of the previous batch) with
        the device computation of this one — the double-buffered form of
        the reference's serving loop (``Decoder.py:190-218``); see
        :class:`poccala_tpu.serve.DecodeService`."""
        import jax.numpy as jnp

        self._prep_device()
        if len(self._roots) == 0:
            return (None, None, int(np.shape(feats)[0]), return_nbest)
        n_frames = np.asarray(n_frames)
        b_orig = int(np.shape(feats)[0])
        if mesh is not None:
            n_data = mesh.shape["data"]
            pad = (-b_orig) % n_data
            if pad:
                feats = np.pad(np.asarray(feats, np.float32),
                               ((0, pad), (0, 0), (0, 0)))
                n_frames = np.pad(n_frames, (0, pad))
        t_pad = int(np.shape(feats)[1])
        n_cand = self._n_cand(return_nbest)
        if mesh is None:
            run = self._run_fn(t_pad, n_cand)
        else:
            run = self._sharded_run_fn(t_pad, n_cand, mesh)
        seqs, scores = run(jnp.asarray(feats, jnp.float32),
                           jnp.asarray(n_frames.astype(np.int32)))
        return (seqs, scores, b_orig, return_nbest)

    def decode_collect(self, handle):
        """Block on a :meth:`decode_dispatch` handle and map ids to
        vocab words (the only host work on the decode path)."""
        seqs, scores, b_orig, return_nbest = handle
        if seqs is None:
            return [[] for _ in range(b_orig)]
        return self._to_hypotheses(np.asarray(seqs), np.asarray(scores),
                                   b_orig, return_nbest)

    @staticmethod
    def _n_cand(return_nbest: int) -> int:
        """Static candidate count for the device n-best extraction
        (rounded up to limit jit cache entries)."""
        return max(8, int(2 ** int(np.ceil(np.log2(max(2, 2 * return_nbest))))))

    def _to_hypotheses(self, seqs, scores, b_orig, return_nbest):
        """ids -> vocab strings; dedup identical word sequences keeping
        the best score (two (end-node, word) pairs can backtrace to the
        same words)."""
        out: list[list[Hypothesis]] = []
        vocab = self._vocab
        for u in range(b_orig):
            best: dict[tuple, float] = {}
            for c in range(seqs.shape[1]):
                if scores[u, c] <= NEG_INF / 2:
                    continue
                ids = seqs[u, c]
                words = tuple(vocab[i] for i in ids if i >= 0)
                if not words:
                    continue
                s = float(scores[u, c])
                if words not in best or s > best[words]:
                    best[words] = s
            hyps = [Hypothesis(score=s, words=w) for w, s in best.items()]
            hyps.sort(reverse=True)
            out.append(hyps[:return_nbest])
        return out

    # ------------------------------------------------------------------
    # program builders
    # ------------------------------------------------------------------

    def _build_lm_fn(self):
        """Word-boundary score function ``(lm_context, word_id) -> f32``
        for traced code: sparse searchsorted lookup, dense flat gather,
        or the constant insertion penalty.  ``lm_context == V`` means
        no-previous-word (unigram row)."""
        import jax.numpy as jnp

        v = self._n_vocab
        pen = float(self.word_penalty)
        if self._j_lm_sparse is not None:
            uni, rboff, cbase, keys, vals = self._j_lm_sparse
            nb = keys.shape[0]

            def f(l_r, w_r):
                w_c = jnp.clip(w_r, 0, v - 1)
                l_c = jnp.clip(l_r, 0, v)
                kq = l_c * v + w_c
                idx = jnp.searchsorted(keys, kq)
                idx_c = jnp.minimum(idx, nb - 1)
                found = (idx < nb) & (keys[idx_c] == kq)
                # unseen pair: per-row backoff (JM: rboff = 0; WB:
                # rboff[p] = w*log10(1-λ_p)) + backoff column
                val = jnp.where(found, vals[idx_c],
                                rboff[l_c] + cbase[w_c])
                return jnp.where(l_r >= v, uni[w_c], val)

            return f
        if self._j_lm_flat is not None:
            lm_flat = self._j_lm_flat

            def f(l_r, w_r):
                return lm_flat[jnp.clip(l_r, 0, None) * v
                               + jnp.clip(w_r, 0, v - 1)]

            return f
        return lambda l_r, w_r: (
            jnp.zeros(jnp.shape(w_r), jnp.float32) - pen)

    def _build_step(self):
        """Per-frame dense update, shared by the one-shot and chunked
        scans.  carry = (deltas [N, Ns], ctx [N, Ns]) where ``ctx``
        packs (traceback ptr + 1, last word) as ``(h+1)*(V+1) + l`` —
        one int32 propagated along the Viterbi path instead of two.

        Formulation notes (chosen for the previous accelerator, where
        dynamic point gathers and minor-axis ``take_along_axis`` were
        slow; not yet measured on the H100): static-index gathers,
        shifted ``where`` selects and scalar picks after an
        ``argmax``/``top_k`` instead.  Hence
        (a) ctx propagates via the same shifted-compare loop as the
        scores, (b) emissions are evaluated on the static (node, word)
        slot arrays, and (c) the bigram LM is applied to the top-``R``
        acoustic emissions only, via a handful of scalar picks — exact
        when there is no LM (adding zero preserves the argmax), the
        standard top-R approximation otherwise."""
        import jax
        import jax.numpy as jnp

        bands, senone = self._j_bands, self._j_senone
        lm_fn = self._build_lm_fn()
        node_slot, word_slot = self._j_node_slot, self._j_word_slot
        slot_valid = self._j_slot_valid
        parent, is_rc = self._j_parent, self._j_is_root_child
        n_nodes, n_s, w_band = bands.shape
        v = self._n_vocab
        vp1 = v + 1
        q = node_slot.shape[0]
        # with no LM the two-phase emission reduces exactly to a single
        # argmax (adding zero preserves the ranking) — skip the top-k
        r_top = 1 if self.lm is None else int(min(q, 16))
        ctx_dead = jnp.int32(v)  # pack(h=-1, l=v)

        def exit_of(deltas, ctx):
            """Max-plus flow into the virtual exit state, with the
            winning source state's packed context (static column
            slices + compare selects; no gathers)."""
            ex = jnp.full((n_nodes,), NEG_INF)
            ex_ctx = jnp.full((n_nodes,), ctx_dead)
            for k in range(1, w_band):
                rr = n_s - 1 - k
                if rr < 0:
                    continue
                cand = deltas[:, rr] + bands[:, rr, k]
                win = cand > ex
                ex = jnp.where(win, cand, ex)
                ex_ctx = jnp.where(win, ctx[:, rr], ex_ctx)
            return ex, ex_ctx

        def emissions(ex, ex_ctx):
            """Best word emission of the frame (two-phase top-R)."""
            ex_q = ex[node_slot]                          # static gather
            ctx_q = ex_ctx[node_slot]
            ac = jnp.where(slot_valid & (ex_q > NEG_INF / 2), ex_q, NEG_INF)
            r_sc, r_ix = jax.lax.top_k(ac, r_top)         # [R]
            w_r = word_slot[r_ix]
            lm_r = lm_fn(ctx_q[r_ix] % vp1, w_r)
            tot = jnp.where(r_sc > NEG_INF / 2, r_sc + lm_r, NEG_INF)
            rb = jnp.argmax(tot)
            e_score = tot[rb]
            slot = r_ix[rb]
            valid = e_score > NEG_INF / 2
            prev_row = jnp.where(valid, ctx_q[slot] // vp1 - 1, -1)
            word_row = jnp.where(valid, word_slot[slot], -1)
            return e_score, prev_row.astype(jnp.int32), \
                word_row.astype(jnp.int32)

        def step(carry, inp):
            deltas, ctx = carry
            frame_scores, ti, active = inp

            # 1. banded in-node advance; ctx rides the same selects
            best = jnp.full_like(deltas, NEG_INF)
            bctx = jnp.full(ctx.shape, ctx_dead)
            for k in range(w_band):
                cand = deltas + bands[:, :, k]
                cctx = ctx
                if k:
                    cand = jnp.concatenate(
                        [jnp.full((n_nodes, k), NEG_INF), cand[:, :-k]],
                        axis=1,
                    )
                    cctx = jnp.concatenate(
                        [jnp.full((n_nodes, k), ctx_dead, jnp.int32),
                         ctx[:, :-k]], axis=1,
                    )
                win = cand > best
                best = jnp.where(win, cand, best)
                bctx = jnp.where(win, cctx, bctx)
            log_b = jnp.where(
                senone >= 0, frame_scores[jnp.clip(senone, 0, None)], NEG_INF
            )
            log_b = log_b.at[:, 0].set(0.0)
            d_new = jnp.maximum(best + log_b, NEG_INF)
            ctx_new = bctx

            # 2-3. exits, best emission, entry refresh
            ex, ex_ctx = exit_of(d_new, ctx_new)
            e_score, prev_row, word_row = emissions(ex, ex_ctx)

            flow = jnp.where(parent >= 0,
                             ex[jnp.clip(parent, 0, None)], NEG_INF)
            flow_ctx = ex_ctx[jnp.clip(parent, 0, None)]
            restart = jnp.where(is_rc, e_score, NEG_INF)
            use_restart = restart > flow
            entry = jnp.maximum(flow, restart)
            re_ctx = (ti + 1) * vp1 + jnp.where(word_row >= 0, word_row, v)
            entry_ctx = jnp.where(use_restart, re_ctx, flow_ctx)

            d_new = d_new.at[:, 0].set(entry)
            ctx_new = ctx_new.at[:, 0].set(entry_ctx)

            deltas = jnp.where(active, d_new, deltas)
            ctx = jnp.where(active, ctx_new, ctx)
            prev_row = jnp.where(active, prev_row, -1)
            word_row = jnp.where(active, word_row, -1)
            return (deltas, ctx), (prev_row, word_row)

        def make_pruned():
            """Block-pruned frame machinery (``active_blocks``) with a
            **compact carry**: only the K active blocks' token scores
            live in the scan carry ([K, blk, Ns] instead of [N, Ns]),
            plus the global entry row and its context ([N]).  The v1
            form kept full-size deltas/ctx and masked — slower than the
            exact search at 21.6k nodes because every frame still paid
            O(N*Ns) carry reads/writes plus full-size
            lookahead and write-back scatters (measured on the previous
            accelerator).  Here the only remaining
            O(N*Ns) term is the per-frame acoustic-score gather feeding
            the block-selection lookahead (fused by XLA into its [N]
            reduce); everything else is O(K*blk*Ns + N).

            Semantics match v1 exactly: per frame the K best blocks by
            one-step lookahead (best token incl. the entry row + best
            emitting acoustic score in the block) run the banded
            advance; unselected blocks lose their interior mass and
            revive through word re-entry / parent flow into their entry
            states, which stay global."""
            blk = self.block_size
            n_blk = n_nodes // blk
            k_act = int(self.active_blocks)
            hyst = float(self.prune_hysteresis)
            bands4 = bands.reshape(n_blk, blk, n_s, w_band)

            def step_pruned(carry, inp):
                kb, d_act, c_act, entry, entry_ctx = carry
                frame_scores, ti, active = inp

                # 0. block selection: per-node one-step lookahead.
                # Acoustic term: best emitting log-density of the node
                # this frame (non-emitting rows gather NEG_INF).  The
                # full [N, Ns] gather feeds a [N] max — XLA fuses the
                # gather into the reduce, so no [N, Ns] materialization
                lb_full = jnp.where(
                    senone >= 0,
                    frame_scores[jnp.clip(senone, 0, None)], NEG_INF)
                la = jnp.max(lb_full, axis=1)               # [N]
                pot = entry + la                            # entry row
                blk_best = jnp.max(pot.reshape(n_blk, blk), axis=1)
                la_act = la.reshape(n_blk, blk)[kb]         # row gather
                int_pot = jnp.max(
                    jnp.max(d_act, axis=2) + la_act, axis=1)    # [K]
                blk_best = blk_best.at[kb].max(int_pot)
                if hyst > 0.0:
                    # sticky selection: an active block keeps its slot
                    # unless a challenger beats it by `hyst` nats
                    # (a dead active block sits at NEG_INF; +hyst is
                    # inconsequential there)
                    blk_best = blk_best.at[kb].add(hyst)
                _, kb_new = jax.lax.top_k(blk_best, k_act)

                # 1. carry remap old->new active set: surviving blocks
                # keep their interior, fresh ones revive dead; every
                # active block's entry state refreshes from the global
                # entry row (the exact step does the same via
                # deltas[:, 0])
                eq = kb_new[:, None] == kb[None, :]
                found = eq.any(axis=1)
                src = jnp.argmax(eq, axis=1)
                d = jnp.where(found[:, None, None], d_act[src], NEG_INF)
                c = jnp.where(found[:, None, None], c_act[src], ctx_dead)
                d = d.at[:, :, 0].set(entry.reshape(n_blk, blk)[kb_new])
                c = c.at[:, :, 0].set(
                    entry_ctx.reshape(n_blk, blk)[kb_new])

                bz = bands4[kb_new]                     # [K, blk, Ns, W]
                log_b = lb_full.reshape(n_blk, blk, n_s)[kb_new]
                log_b = log_b.at[..., 0].set(0.0)

                # 2. banded in-node advance on active blocks only
                best = jnp.full_like(d, NEG_INF)
                bctx = jnp.full(c.shape, ctx_dead)
                for k in range(w_band):
                    cand = d + bz[..., k]
                    cctx = c
                    if k:
                        cand = jnp.concatenate(
                            [jnp.full((k_act, blk, k), NEG_INF),
                             cand[..., :-k]], axis=-1)
                        cctx = jnp.concatenate(
                            [jnp.full((k_act, blk, k), ctx_dead,
                                      jnp.int32),
                             c[..., :-k]], axis=-1)
                    win = cand > best
                    best = jnp.where(win, cand, best)
                    bctx = jnp.where(win, cctx, bctx)
                d_new = jnp.maximum(best + log_b, NEG_INF)
                ctx_adv = bctx

                # 3. exit flow of active blocks, scattered to flat [N]
                ex_k = jnp.full((k_act, blk), NEG_INF)
                exc_k = jnp.full((k_act, blk), ctx_dead)
                for k in range(1, w_band):
                    rr = n_s - 1 - k
                    if rr < 0:
                        continue
                    cand = d_new[..., rr] + bz[..., rr, k]
                    win = cand > ex_k
                    ex_k = jnp.where(win, cand, ex_k)
                    exc_k = jnp.where(win, ctx_adv[..., rr], exc_k)
                ex = jnp.full((n_blk, blk), NEG_INF).at[kb_new].set(
                    ex_k).reshape(-1)
                ex_ctx = jnp.full((n_blk, blk), ctx_dead,
                                  jnp.int32).at[kb_new].set(
                    exc_k).reshape(-1)

                # 4-5. emission + entry refresh: global flat [N]/[Q]
                e_score, prev_row, word_row = emissions(ex, ex_ctx)
                flow = jnp.where(parent >= 0,
                                 ex[jnp.clip(parent, 0, None)], NEG_INF)
                flow_ctx = ex_ctx[jnp.clip(parent, 0, None)]
                restart = jnp.where(is_rc, e_score, NEG_INF)
                use_restart = restart > flow
                entry_new = jnp.maximum(flow, restart)
                re_ctx = (ti + 1) * vp1 + jnp.where(
                    word_row >= 0, word_row, v)
                entry_ctx_new = jnp.where(use_restart, re_ctx, flow_ctx)

                # 6. freeze everything on inactive (padded) frames
                kb_o = jnp.where(active, kb_new, kb)
                d_o = jnp.where(active, d_new, d_act)
                c_o = jnp.where(active, ctx_adv, c_act)
                entry_o = jnp.where(active, entry_new, entry)
                ectx_o = jnp.where(active, entry_ctx_new, entry_ctx)
                prev_row = jnp.where(active, prev_row, -1)
                word_row = jnp.where(active, word_row, -1)
                return (kb_o, d_o, c_o, entry_o, ectx_o), \
                    (prev_row, word_row)

            def seed_pruned():
                entry0 = jnp.where(is_rc, 0.0, NEG_INF)
                ectx0 = jnp.full((n_nodes,), ctx_dead, jnp.int32)
                kb0 = jnp.arange(k_act, dtype=jnp.int32)
                d0 = jnp.full((k_act, blk, n_s), NEG_INF)
                d0 = d0.at[:, :, 0].set(entry0.reshape(n_blk, blk)[kb0])
                c0 = jnp.full((k_act, blk, n_s), ctx_dead, jnp.int32)
                return (kb0, d0, c0, entry0, ectx0)

            def expand_pruned(carry):
                """Compact carry -> full (deltas, ctx) for finalize /
                exit_of (one-time cost at the end of the scan)."""
                kb, d_act, c_act, entry, entry_ctx = carry
                d3 = jnp.full((n_blk, blk, n_s), NEG_INF).at[kb].set(
                    d_act)
                c3 = jnp.full((n_blk, blk, n_s), ctx_dead,
                              jnp.int32).at[kb].set(c_act)
                deltas = d3.reshape(n_nodes, n_s).at[:, 0].set(entry)
                ctx = c3.reshape(n_nodes, n_s).at[:, 0].set(entry_ctx)
                return deltas, ctx

            return step_pruned, seed_pruned, expand_pruned

        def seed():
            deltas0 = jnp.full((n_nodes, n_s), NEG_INF)
            deltas0 = deltas0.at[:, 0].set(jnp.where(is_rc, 0.0, NEG_INF))
            ctx0 = jnp.full((n_nodes, n_s), ctx_dead, jnp.int32)
            return (deltas0, ctx0)

        if getattr(self, "_prune_on", False):
            return make_pruned() + (exit_of,)
        return step, seed, (lambda carry: carry), exit_of

    def _build_finalize(self, n_cand: int):
        """Device n-best: final exits -> top emissions over the static
        (node, word) slots -> pointer-chase backtrace."""
        import jax
        import jax.numpy as jnp

        lm_fn = self._build_lm_fn()
        node_slot, word_slot = self._j_node_slot, self._j_word_slot
        slot_valid = self._j_slot_valid
        v = self._n_vocab
        vp1 = v + 1
        q = node_slot.shape[0]
        l_max = self.max_words
        n_cand = min(n_cand, int(q))
        r_fin = int(min(q, max(32, 2 * n_cand)))
        _, _, expand, exit_of = self._build_step()

        def finalize(carry, tb_prev, tb_word):
            deltas, ctx = expand(carry)
            ex, ex_ctx = exit_of(deltas, ctx)
            ex_q = ex[node_slot]
            ctx_q = ex_ctx[node_slot]
            ac = jnp.where(slot_valid & (ex_q > NEG_INF / 2), ex_q, NEG_INF)
            r_sc, r_ix = jax.lax.top_k(ac, r_fin)
            w_r = word_slot[r_ix]
            c_r = ctx_q[r_ix]
            lm_r = lm_fn(c_r % vp1, w_r)
            tot = jnp.where(r_sc > NEG_INF / 2, r_sc + lm_r, NEG_INF)
            scores, c_ix = jax.lax.top_k(tot, n_cand)
            last_words = w_r[c_ix]                          # [C]
            ptrs = c_r[c_ix] // vp1 - 1                     # [C]

            def chase(ptr):
                def st(p, _):
                    w = jnp.where(p >= 0, tb_word[jnp.clip(p, 0, None)], -1)
                    nx = jnp.where(p >= 0, tb_prev[jnp.clip(p, 0, None)], -1)
                    return nx, w
                _, ws = jax.lax.scan(st, ptr, None, length=l_max - 1)
                return ws                                   # newest-first

            rev = jnp.concatenate(
                [last_words[:, None], jax.vmap(chase)(ptrs)], axis=1
            )                                               # [C, L]
            valid_c = scores > NEG_INF / 2
            rev = jnp.where(valid_c[:, None], rev, -1)
            lens = jnp.sum(rev >= 0, axis=1)
            pos = lens[:, None] - 1 - jnp.arange(l_max)[None]
            seqs = jnp.where(
                pos >= 0,
                jnp.take_along_axis(rev, jnp.clip(pos, 0, None), axis=1),
                -1,
            )
            return seqs.astype(jnp.int32), scores

        return finalize

    def _build_run(self, t_pad: int, n_cand: int):
        """Raw (unjitted) ``run(feats [B,T,D], n_frames [B])`` program:
        GMM scoring + Viterbi scan + n-best extraction in one graph."""
        import jax
        import jax.numpy as jnp

        step, seed, _, _ = self._build_step()
        finalize = self._build_finalize(n_cand)

        def run(feats_b, n_frames_b):
            b = feats_b.shape[0]
            scores_b = self._scores_in_graph(feats_b)

            def one_utt(scores_u, n_frames_u):
                tis = jnp.arange(t_pad, dtype=jnp.int32)
                actives = tis < n_frames_u
                # unroll=2: two fused body copies halve the per-frame
                # round trips of the [N, Ns] carry through device memory
                # (chosen for the previous accelerator)
                carry, (tbp, tbw) = jax.lax.scan(
                    step, seed(), (scores_u, tis, actives), unroll=2
                )
                return finalize(carry, tbp, tbw)

            return jax.vmap(one_utt)(scores_b, n_frames_b)

        return run

    def _scores_in_graph(self, feats_b):
        """All-frames × all-senones GMM scores, traced into the decode
        program (one jit: scoring + scan + finalize)."""
        from poccala_tpu.ops.gmm_score import gmm_log_scores

        b, t, d = feats_b.shape
        s = gmm_log_scores(
            feats_b.reshape(b * t, d), self.bank.means, self.bank.log_var,
            self.bank.log_w, normalizer=self.normalizer,
            score_dtype=self.score_dtype,
        )
        return s.reshape(b, t, -1)

    def _run_fn(self, t_pad: int, n_cand: int):
        import jax

        cache = getattr(self, "_run_cache", None)
        if cache is None:
            cache = self._run_cache = {}
        key = (t_pad, n_cand)
        if key not in cache:
            cache[key] = jax.jit(self._build_run(t_pad, n_cand))
        return cache[key]

    def _sharded_run_fn(self, t_pad: int, n_cand: int, mesh):
        """The same program wrapped in ``shard_map`` over the ``data``
        axis — per-utterance decode is independent, so the shard program
        has zero collectives; tables and bank are closed over and
        replicated."""
        import jax
        from jax import shard_map as _shard_map
        from jax.sharding import PartitionSpec as P

        cache = getattr(self, "_sharded_cache", None)
        if cache is None:
            cache = self._sharded_cache = {}
        key = (t_pad, n_cand, id(mesh))
        if key not in cache:
            run = self._build_run(t_pad, n_cand)
            spec = P("data")
            mapped = _shard_map(
                run, mesh=mesh,
                in_specs=(spec, spec),
                out_specs=(spec, spec),
                check_vma=False,
            )
            cache[key] = jax.jit(mapped)
        return cache[key]

    # ------------------------------------------------------------------
    # Streaming (online) decode: the reference's serving intent —
    # record → VAD → decode (Decoder.py:190-218) — as a chunk-
    # incremental API.  The scan carry (deltas, hist, last) and the
    # traceback lattice persist across chunks; lattice pointers are
    # absolute frame indices, so concatenated per-chunk rows form the
    # same [T_total] table the one-shot scan writes, and a chunked
    # decode reproduces the one-shot result exactly (pinned in
    # tests/test_streaming_decode.py).
    # ------------------------------------------------------------------

    def stream_init(self, batch: int = 1, max_frames: int = 4096):
        """Start a streaming decode session.

        :param batch: number of parallel audio streams
        :param max_frames: total-frame capacity (sizes the traceback
            table; exceeding it raises at feed time)
        """
        self._prep_device()
        return _StreamState(batch=batch, max_frames=max_frames)

    def stream_feed(self, st, feats_chunk, n_valid=None):
        """Advance the decoder over one feature chunk.

        :param feats_chunk: ``[B, Tc, D]`` (or ``[Tc, D]`` when
            ``batch == 1``) — VAD-kept frames only, as in the
            reference's serving loop
        :param n_valid: ``[B]`` valid frame counts (default: full chunk)
        """
        import jax.numpy as jnp

        feats_chunk = np.asarray(feats_chunk, np.float32)
        if feats_chunk.ndim == 2:
            feats_chunk = feats_chunk[None]
        b, t_c, _ = feats_chunk.shape
        if b != st.batch:
            raise ValueError(f"stream batch {st.batch} != chunk batch {b}")
        if st.t_offset + t_c > st.max_frames:
            raise ValueError(
                f"stream exceeds max_frames={st.max_frames}; "
                f"restart with a larger capacity"
            )
        if n_valid is None:
            n_valid = np.full((b,), t_c, np.int32)
        run = self._chunk_fn(t_c)
        if st.carry is None:
            st.carry = self._seed_fn()(st.batch)
        st.carry, (tb_prev, tb_word) = run(
            st.carry,
            jnp.asarray(feats_chunk),
            jnp.asarray(np.int32(st.t_offset)),
            jnp.asarray(n_valid.astype(np.int32)),
        )
        st.tb_prev.append(np.asarray(tb_prev))   # [B, Tc]
        st.tb_word.append(np.asarray(tb_word))
        st.t_offset += t_c
        return st

    def stream_result(self, st, return_nbest: int = 1):
        """Current n-best hypotheses (callable at any point; the stream
        may continue afterwards)."""
        import jax.numpy as jnp

        if st.carry is None:
            return [[] for _ in range(st.batch)]
        tb_prev = np.concatenate(st.tb_prev, axis=1)
        tb_word = np.concatenate(st.tb_word, axis=1)
        pad = st.max_frames - tb_prev.shape[1]
        if pad:
            tb_prev = np.pad(tb_prev, ((0, 0), (0, pad)),
                             constant_values=-1)
            tb_word = np.pad(tb_word, ((0, 0), (0, pad)),
                             constant_values=-1)
        n_cand = self._n_cand(return_nbest)
        fin = self._finalize_fn(st.max_frames, n_cand)
        seqs, scores = fin(st.carry, jnp.asarray(tb_prev),
                           jnp.asarray(tb_word))
        return self._to_hypotheses(np.asarray(seqs), np.asarray(scores),
                                   st.batch, return_nbest)

    def decode_stream(self, chunks, return_nbest: int = 1):
        """Convenience: decode one utterance (or batch) delivered as a
        list of feature chunks; equals the one-shot
        :meth:`decode_batch` on the concatenated features."""
        chunks = [np.asarray(c, np.float32) for c in chunks]
        if not chunks:
            return []
        b = 1 if chunks[0].ndim == 2 else chunks[0].shape[0]
        total = sum(c.shape[-2] for c in chunks)
        st = self.stream_init(batch=b, max_frames=total)
        for c in chunks:
            st = self.stream_feed(st, c)
        return self.stream_result(st, return_nbest=return_nbest)

    def _chunk_fn(self, t_c: int):
        import jax
        import jax.numpy as jnp

        cache = getattr(self, "_chunk_cache", None)
        if cache is None:
            cache = self._chunk_cache = {}
        if t_c in cache:
            return cache[t_c]
        step, _, _, _ = self._build_step()

        def run_chunk(carry_b, feats_b, t0, n_valid_b):
            scores_b = self._scores_in_graph(feats_b)

            def one_utt(carry_u, scores_u, n_valid_u):
                tis = t0 + jnp.arange(t_c, dtype=jnp.int32)
                actives = jnp.arange(t_c) < n_valid_u
                return jax.lax.scan(step, carry_u, (scores_u, tis, actives))

            return jax.vmap(one_utt, in_axes=(0, 0, 0))(
                carry_b, scores_b, n_valid_b
            )

        fn = jax.jit(run_chunk)
        cache[t_c] = fn
        return fn

    def _seed_fn(self):
        import jax
        import jax.numpy as jnp

        _, seed, _, _ = self._build_step()

        def make(batch: int):
            one = seed()
            return jax.tree.map(
                lambda x: jnp.broadcast_to(x[None], (batch,) + x.shape), one
            )

        return make

    def _finalize_fn(self, max_frames: int, n_cand: int):
        import jax

        cache = getattr(self, "_fin_cache", None)
        if cache is None:
            cache = self._fin_cache = {}
        key = (max_frames, n_cand)
        if key not in cache:
            finalize = self._build_finalize(n_cand)
            cache[key] = jax.jit(jax.vmap(finalize))
        return cache[key]
