"""Batched decoding for eval: greedy with carried stats, and beam search.

Port of the eval routes of ``captioning_tpu/engine/decoding.py``:

* ``sample`` — greedy with the entropy / chosen-logprob sums carried and
  the exact early exit once every row has finished; through the fused
  ``k = 1`` vocab epilogue when the model has ``step_topk``, else through
  the plain step's float32 log-softmax table;
* ``sample_beam`` -> ``_beam_search_fast`` — single group, with the
  finished-beam pool merge and the exact early exit; fused (per-row
  top-``bdash`` survivors from the vocab epilogue, the t = 0 lane-0 top-k)
  when the model has ``step_topk``, else the plain branch (the full
  [B*bdash, V+1] candidate table, its ``[B, bdash*(V+1)]`` top-k, UNK
  adjust, temperature log-softmax).  Beam state follows the model's
  ancestry table when it has one, else a plain row gather.

The JAX scans become host loops; the early-exit condition costs one host
sync per step.  Every top-k resolves a tie to the lowest index, as
``lax.top_k``: the beam and pool merges are full of exact ties (NEG fills,
lane-0 masking, pool entries that must win ties against candidates).  The
plain branch's selection over the full ``[B, bdash*(V+1)]`` table goes
through ``ops.topk.topk_lastdim`` (a CUDA kernel on the card); the small
merges over [B, bdash²] and [B, 2·bdash] use the stable-sort ``top_k``.
The JAX gates ``NBG % 8 == 0`` and ``N % 8 == 0`` in front of the fused
branches are TPU tiling rules and are dropped: the CUDA kernels take any
row count.

Not ported yet (each raises ``NotImplementedError``; see ROADMAP.md):
diverse groups, decoding constraints, bad-ending removal, trigram
blocking, the winner-logprob replay (``want_logps=True``) and the
non-greedy sample methods.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..ops.topk import top_k, topk_lastdim

NEG = -1e30  # "never selected" sentinel (finite to keep arithmetic NaN-free)
_ROADMAP = 'not ported yet; see ROADMAP.md, Queue A'


@dataclasses.dataclass(frozen=True)
class DecodeModel:
    """A captioner bound for decoding.

    ``step(it, feats, state, rng, logsoftmax, uniform_t, beam_width) ->
    (float32 [N, V+1] log-probs or logits, state)``: one plain step.
    ``step_topk(it, feats, state, rng, k, temp, unk_bias, unk_idx,
    beam_width) -> (top_lsm [N, k], top_ix [N, k], row_sum [N], ent [N],
    state)``: one step plus the fused vocab epilogue, used when set.
    ``beam_init(state, bdash)`` adds the ancestry table after lane
    replication; ``beam_reorder(state, flat_idx)`` gathers every leaf but
    the physical caches; without them beam rows are reordered by a plain
    gather.  The JAX protocol's bad-ending ids serve routes not ported yet
    and come back with them."""
    prepare: Callable  # (fc, att, att_masks, rng) -> feats
    init_state: Callable  # (batch, beam=False) -> state
    step: Callable
    seq_length: int
    vocab_plus: int  # V + 1
    bos_idx: int = 0
    eos_idx: int = 0
    pad_idx: int = 0
    unk_idx: Optional[int] = None
    beam_init: Optional[Callable] = None
    beam_reorder: Optional[Callable] = None
    shared_beam_feats: bool = False
    step_topk: Optional[Callable] = None


def repeat_tree(n: int, tree):
    """B x ... -> B*n x ... with the repeat index fastest."""
    if n == 1:
        return tree
    if isinstance(tree, dict):
        return {k: repeat_tree(n, v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.repeat_interleave(n, dim=0)
    return tree


def reorder_state(tree, idx):
    """Beam-reorder every tensor leaf's leading dim by ``idx`` (a row
    gather; the JAX engine's one-hot matmul is an exact TPU substitute)."""
    return {k: v.index_select(0, idx) if torch.is_tensor(v) else v
            for k, v in tree.items()}


def penalty_fn(length_penalty: str):
    """Beam length penalty from its '<type>_<alpha>' spec."""
    if not length_penalty:
        return penalty_fn_dynamic('', 0.0)
    pen_type, alpha = length_penalty.split('_')
    return penalty_fn_dynamic(pen_type, float(alpha))


def penalty_fn_dynamic(pen_type: str, alpha: float):
    """``(length, logprobs) -> penalized``, computed in float32 as the JAX
    engine computes it with a traced float32 alpha."""
    if not pen_type:
        return lambda length, logprobs: logprobs
    if pen_type == 'wu':
        a = torch.tensor(alpha, dtype=torch.float32)

        def wu(length, logprobs):
            mod = ((5.0 + torch.tensor(float(length))) ** a) / (
                torch.tensor(6.0) ** a)
            return logprobs / mod.to(logprobs.device)
        return wu
    if pen_type == 'avg':
        return lambda length, logprobs: logprobs / max(float(length), 1.0)
    raise ValueError('unknown length_penalty %s' % pen_type)


def _beam_dynamic_setup(dm: DecodeModel, opt: Dict[str, Any]):
    """(temperature, length-penalty fn, unk_bias, unk_idx) for the vocab
    epilogue: UNK suppression adds -1000 at ``unk_idx`` after the
    log-softmax."""
    temperature = float(opt.get('temperature', 1.0) or 1.0)
    length_penalty = penalty_fn(opt.get('length_penalty', '') or '')
    suppress = int(opt.get('suppress_UNK', 0) or 0)
    if suppress and dm.unk_idx is not None:
        return temperature, length_penalty, -1000.0, int(dm.unk_idx)
    return temperature, length_penalty, 0.0, -1


def _check_slice(opt: Dict[str, Any]):
    for flag in ('decoding_constraint', 'remove_bad_endings',
                 'block_trigrams'):
        if int(opt.get(flag, 0) or 0):
            raise NotImplementedError('%s: %s' % (flag, _ROADMAP))
    if int(opt.get('group_size', 1) or 1) > 1:
        raise NotImplementedError('group_size > 1 (diverse beam): %s'
                                  % _ROADMAP)


# ---------------------------------------------------------------------------
# greedy with carried stats
# ---------------------------------------------------------------------------

def sample(dm: DecodeModel, fc_feats, att_feats, att_masks, rng,
           opt: Dict[str, Any], return_stats: bool = True):
    """Greedy decode.  Returns (seq [B*n, L] int64, {'ent_sum', 'lp_sum'}
    [B*n] float32).  Beam options route to ``sample_beam``."""
    sample_method = opt.get('sample_method', 'greedy') or 'greedy'
    beam_size = int(opt.get('beam_size', 1) or 1)
    if beam_size > 1 and sample_method in ('greedy', 'beam_search'):
        seq, stats, _ = sample_beam(dm, fc_feats, att_feats, att_masks, rng,
                                    opt, want_logps=not return_stats)
        return seq, stats
    _check_slice(opt)
    if sample_method != 'greedy':
        raise NotImplementedError('sample_method %r: %s'
                                  % (sample_method, _ROADMAP))
    if not return_stats or not int(opt.get('output_logsoftmax', 1)):
        raise NotImplementedError('per-step logprob tables: %s' % _ROADMAP)
    sample_n = int(opt.get('sample_n', 1) or 1)
    L = dm.seq_length
    feats = dm.prepare(fc_feats, att_feats, att_masks, rng)
    if not dm.shared_beam_feats:
        feats = repeat_tree(sample_n, feats)
    N = fc_feats.shape[0] * sample_n
    state = dm.init_state(N)
    dev = att_feats.device
    it = torch.full((N,), dm.bos_idx, dtype=torch.long, device=dev)
    unfinished = torch.ones(N, dtype=torch.bool, device=dev)
    seq = torch.zeros(N, L, dtype=torch.long, device=dev)
    ent_sum = torch.zeros(N, dtype=torch.float32, device=dev)
    lp_sum = torch.zeros(N, dtype=torch.float32, device=dev)
    for t in range(L):
        # eval stats and the argmax are taken on the untempered
        # log-softmax (no UNK suppression outside beam search)
        if dm.step_topk is not None:
            tv, ti, _, en, state = dm.step_topk(it, feats, state, rng, 1,
                                                1.0, 0.0, -1, 0)
            tv, ti = tv[:, 0], ti[:, 0]
        else:
            lsm, state = dm.step(it, feats, state, rng, True, uniform_t=True)
            ti = lsm.argmax(1)       # the first maximum, as jnp.argmax
            tv = lsm.gather(1, ti[:, None])[:, 0]
            en = -(lsm.exp() * lsm).sum(-1)
        keep = unfinished if t else torch.ones_like(unfinished)
        it = torch.where(keep, ti, dm.pad_idx)
        unfinished = keep & (it != dm.eos_idx)
        seq[:, t] = it
        ent_sum += torch.where(keep, en, 0.0)
        lp_sum += torch.where(keep, tv, 0.0)
        # EXACT early exit: once every row has finished, the remaining
        # steps only write pads and gated-off stats (one host sync)
        if not bool(unfinished.any()):
            break
    return seq, {'ent_sum': ent_sum, 'lp_sum': lp_sum}


# ---------------------------------------------------------------------------
# beam search (single group)
# ---------------------------------------------------------------------------

def _gather(x, ix):
    """take_along_axis(x, ix, axis=1) for [B, R(, ...)] tables."""
    if x.dim() == 2:
        return torch.gather(x, 1, ix)
    return torch.gather(x, 1, ix[..., None].expand(-1, -1, x.shape[2]))


def _unk_adjust(lsm, unk_bias: float, unk_idx: int):
    if unk_idx < 0:
        return lsm
    lsm = lsm.clone()
    lsm[:, unk_idx] += unk_bias
    return lsm


def _beam_search_fast(dm: DecodeModel, init, init_state, feats_per_beam,
                      rng, opt: Dict[str, Any]):
    """Single-group beam search.

    With ``dm.step_topk`` (fused): ``init`` = (tv0 [B, bdash], ti0,
    row_sum0 [B], ent0 [B]), the vocab epilogue of the bos step
    (UNK-adjusted, temperature 1), and each step carries per-row
    top-``bdash`` survivors.  Without it: ``init`` is the bos step's
    float32 log-softmax [B, V+1], and each step carries the full candidate
    table ``lsm' + beam sum`` [B*bdash, V+1] (``_finish_table``).  Returns
    the finished-beam pool as {'seq' [B, 1, bdash, L], 'p', 'unaug_p',
    'ent_sum', 'lp_sum' [B, 1, bdash]}, sorted descending by ``p``."""
    temperature, length_penalty, unk_bias, unk_idx = _beam_dynamic_setup(
        dm, opt)
    bdash = int(opt.get('beam_size', 10))
    fused = dm.step_topk is not None
    use_anc = dm.beam_init is not None and dm.beam_reorder is not None
    step_bw = bdash if use_anc else 0
    B = init[0].shape[0] if fused else init.shape[0]
    L = dm.seq_length
    NBG = B * bdash
    if fused:
        tv0, ti0, rs0, en0 = init
    else:
        V1 = dm.vocab_plus
        lsm0 = _unk_adjust(init, unk_bias, unk_idx)         # [B, V1]
        rs0 = lsm0.sum(-1)
        en0 = -(lsm0.exp() * lsm0).sum(-1)
    dev = rs0.device
    f32 = dict(dtype=torch.float32, device=dev)

    state = repeat_tree(bdash, init_state)
    if use_anc:
        state = dm.beam_init(state, bdash)

    # t = 0: every lane holds the bos distribution; lane 0's candidates
    # are the bos ones, the other lanes are masked off
    lane0 = (torch.arange(bdash, device=dev) == 0).view(1, bdash, 1)
    if fused:
        # lane 0's top-bdash is the global top-bdash
        tv_c = torch.where(lane0, tv0[:, None, :], NEG).reshape(NBG, bdash)
        ti_c = ti0[:, None, :].expand(B, bdash, bdash).reshape(NBG, bdash)
    else:
        cand = (lsm0[:, None, :] + torch.where(lane0, 0.0, NEG)
                ).reshape(NBG, V1)
    row_sum = rs0[:, None].expand(B, bdash)
    ent_row = en0[:, None].expand(B, bdash)

    beam_seq = torch.zeros(B, bdash, L, dtype=torch.long, device=dev)
    beam_ucum = torch.zeros(B, bdash, **f32)
    beam_sums = torch.zeros(B, bdash, **f32)
    beam_ent = torch.zeros(B, bdash, **f32)
    beam_lpc = torch.zeros(B, bdash, **f32)
    pool_seq = torch.zeros(B, bdash, L, dtype=torch.long, device=dev)
    pool_p = torch.full((B, bdash), NEG, **f32)
    pool_unaug = torch.full((B, bdash), NEG, **f32)
    pool_ent = torch.zeros(B, bdash, **f32)
    pool_lpc = torch.zeros(B, bdash, **f32)
    base = torch.arange(B, device=dev)[:, None] * bdash

    for t in range(L):
        if fused:
            # ---- selection over the per-row survivors + the beam-sum
            # shift; entries are (beam, rank)-ordered, so flat ties resolve
            # to the lowest beam, then the lowest vocab index ----
            cand_s = (tv_c.view(B, bdash, bdash) + beam_sums[:, :, None]
                      ).view(B, bdash * bdash)
            ys, jx = top_k(cand_s, bdash)
            beam_ix = jx // bdash
            sel_ix = torch.gather(ti_c.reshape(B, bdash * bdash), 1, jx)
        else:
            # ---- selection over the full candidate table (the beam sums
            # are already in it); flat ties go to the lowest beam, then
            # the lowest vocab index ----
            ys, ix = topk_lastdim(cand.view(B, bdash * V1), bdash)
            beam_ix = ix // V1
            sel_ix = ix % V1

        new_seq = _gather(beam_seq, beam_ix)
        new_seq[:, :, t] = sel_ix
        new_ucum = _gather(beam_ucum, beam_ix) + _gather(row_sum, beam_ix)
        new_ent = _gather(beam_ent, beam_ix) + _gather(ent_row, beam_ix)
        # chosen-token logprob: the candidate minus the parent's sum
        new_lpc = _gather(beam_lpc, beam_ix) + (ys - _gather(beam_sums,
                                                             beam_ix))
        new_sums = ys

        # ---- finished-beam pool merge; pool entries precede candidates,
        # so ties keep the pool entry ----
        just_ended = (sel_ix == dm.eos_idx) | (t == L - 1)
        cand_p = torch.where(just_ended, length_penalty(t + 1, new_sums),
                             NEG)
        top_p, top_i = top_k(torch.cat([pool_p, cand_p], 1), bdash)
        pool_p = top_p
        pool_unaug = _gather(torch.cat([pool_unaug, new_ucum], 1), top_i)
        pool_seq = _gather(torch.cat([pool_seq, new_seq], 1), top_i)
        pool_ent = _gather(torch.cat([pool_ent, new_ent], 1), top_i)
        pool_lpc = _gather(torch.cat([pool_lpc, new_lpc], 1), top_i)
        beam_sums = new_sums - 1000.0 * just_ended
        beam_seq, beam_ucum, beam_ent, beam_lpc = (new_seq, new_ucum,
                                                   new_ent, new_lpc)

        # ---- EXACT early exit: stop once no image's pool can change.
        # A future candidate's raw sum is bounded by the current best lane
        # sum (log-probs <= 0), its penalized score by that sum at the
        # lengths t+2..L (t+1 too, for a length-decreasing penalty); when
        # that cannot strictly beat the worst pool entry, the pool is
        # final.  Checked before the model step, whose output the exit
        # would discard (one host sync per step). ----
        if t + 1 >= L:
            break
        max_sums = beam_sums.max(1).values
        bound = torch.maximum(
            torch.maximum(length_penalty(L, max_sums),
                          length_penalty(t + 3, max_sums)),
            length_penalty(t + 2, max_sums))
        if not bool((bound > pool_p.min(1).values).any()):
            break

        # ---- model step + vocab epilogue ----
        flat_idx = (base + beam_ix).view(-1)
        state = (dm.beam_reorder(state, flat_idx) if use_anc
                 else reorder_state(state, flat_idx))
        it = sel_ix.view(NBG)
        if fused:
            tv_c, ti_c, rs, en, state = dm.step_topk(
                it, feats_per_beam, state, rng, bdash, temperature,
                unk_bias, unk_idx, step_bw)
            row_sum = rs.view(B, bdash)
            ent_row = en.view(B, bdash)
        else:
            logits, state = dm.step(it, feats_per_beam, state, rng, False,
                                    uniform_t=True, beam_width=step_bw)
            cand, row_sum, ent_row = _finish_table(
                torch.log_softmax(logits / temperature, dim=-1), beam_sums,
                unk_bias, unk_idx)

    return {'seq': pool_seq[:, None], 'p': pool_p[:, None],
            'unaug_p': pool_unaug[:, None], 'ent_sum': pool_ent[:, None],
            'lp_sum': pool_lpc[:, None]}


def _finish_table(lsm, sums, unk_bias: float, unk_idx: int):
    """The plain branch's pass over a fresh [B*bdash, V+1] log-softmax
    table: UNK adjust, the two carried-stat reductions and the candidate
    add for the next selection."""
    B, bdash = sums.shape
    lsm = _unk_adjust(lsm, unk_bias, unk_idx)
    row_sum = lsm.sum(-1)
    ent_row = -(lsm.exp() * lsm).sum(-1)
    cand = lsm + sums.reshape(-1, 1)
    return cand, row_sum.view(B, bdash), ent_row.view(B, bdash)


def sample_beam(dm: DecodeModel, fc_feats, att_feats, att_masks, rng,
                opt: Dict[str, Any], want_logps: bool = False):
    """Beam decode.  Returns (seq [B*sample_n, L], {'ent_sum', 'lp_sum'}
    [B*sample_n], done) with ``done`` the pool of ``_beam_search_fast``."""
    _check_slice(opt)
    if want_logps:
        raise NotImplementedError('want_logps=True (winner-logprob '
                                  'replay): %s' % _ROADMAP)
    bdash = int(opt.get('beam_size', 10))
    sample_n = int(opt.get('sample_n', 1) or 1)
    if sample_n not in (1, bdash):
        raise ValueError('when beam search, sample_n == 1 or beam size')
    _, _, unk_bias, unk_idx = _beam_dynamic_setup(dm, opt)
    B = fc_feats.shape[0]
    L = dm.seq_length

    feats = dm.prepare(fc_feats, att_feats, att_masks, rng)
    state = dm.init_state(B, beam=True)
    it = torch.full((B,), dm.bos_idx, dtype=torch.long,
                    device=att_feats.device)
    # the bos step's distribution is untempered (the reference applies the
    # temperature from the second step on)
    if dm.step_topk is not None:
        *init, state = dm.step_topk(it, feats, state, rng, bdash, 1.0,
                                    unk_bias, unk_idx, 0)
    else:
        init, state = dm.step(it, feats, state, rng, True, uniform_t=True)
    # beam lanes of one image share its feats row (shared_beam_feats)
    feats_per_beam = feats if dm.shared_beam_feats else repeat_tree(
        bdash, feats)
    done = _beam_search_fast(dm, init, state, feats_per_beam, rng, opt)
    if sample_n == 1:
        seq = done['seq'][:, 0, 0]
        stats = {'ent_sum': done['ent_sum'][:, 0, 0],
                 'lp_sum': done['lp_sum'][:, 0, 0]}
    else:
        seq = done['seq'][:, 0].reshape(B * sample_n, L)
        stats = {'ent_sum': done['ent_sum'][:, 0].reshape(B * sample_n),
                 'lp_sum': done['lp_sum'][:, 0].reshape(B * sample_n)}
    return seq, stats, done
