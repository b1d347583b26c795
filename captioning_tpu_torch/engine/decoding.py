"""Batched decoding: greedy and sampling, beam search (one group or diverse
groups), diverse sampling, the winner-logprob replay and the logprob
recompute.

Port of ``captioning_tpu/engine/decoding.py``:

* ``sample`` — greedy, gumbel, temperature sampling, top-k and top-p, with
  the step constraints (``decoding_constraint``, ``remove_bad_endings``,
  ``block_trigrams``); the per-step ``[N, L, V+1]`` tables, or (with
  ``return_stats``) the entropy / chosen-logprob sums carried with the
  exact early exit once every row has finished.  Greedy stats go through
  the fused ``k = 1`` vocab epilogue when the model has ``step_topk``.
  Beam options route to ``sample_beam``, ``group_size > 1`` to
  ``diverse_sample``.  Given a dropout ``generator`` it samples in train
  mode, as the RL steps do;
* ``sample_beam`` -> ``beam_program`` (one group without the scatter
  constraints: the finished-beam pool merge and the exact early exit;
  fused per-row top-``bdash`` survivors when the model has ``step_topk``,
  else the full candidate table) or ``beam_search`` (the general body:
  diverse groups with their penalty, the constraints, UNK suppression and
  the freeze of the groups outside their time window); with
  ``want_logps`` the winners' per-step distributions are replayed
  (``replay_beam_logps``);
* ``diverse_sample`` — staggered groups with the batch-pooled diversity
  penalty;
* ``scan_logprobs`` — the recompute over a given sequence, in train mode
  (an autograd graph, dropout drawn from a generator) when given one.

The JAX scans become host loops over host-int steps; an early exit costs
one host sync per step.  The single-group beam and ``sample``'s loop are
``StepProgram``s: a setup and a per-step body over a ``Carry`` whose
tensors keep their addresses, so ``engine.graphs`` can capture each step
as a CUDA graph (the counterpart of the JAX package's jitted decodes); the
eager loop runs the same body.  Every top-k resolves a tie to the lowest
index, as ``lax.top_k``.  The selections over a full ``[B,
bdash*(V+1)]`` table go through ``ops.topk.topk_lastdim`` (a CUDA kernel
on the card, ``bdash <= 16``); the small merges over [B, bdash²] and [B,
2·bdash] use the stable-sort ``top_k``.  The JAX gates ``NBG % 8 == 0`` / ``N % 8 == 0`` in
front of the fused branches are TPU tiling rules and are dropped.

Randomness: every sampled step takes its noise from ``draw(kind, t,
shape)`` with ``kind`` 'uniform' (gumbel sampling) or 'gumbel' (the
categorical, ``argmax(logits + gumbel)`` as ``jax.random.categorical``).
The ``rng`` of a decode is a ``torch.Generator`` on the decode's device
(``generator_draw``), such a ``draw`` callable, or None (a generator seeded
0).  Eval model steps draw nothing: the engine hands them no rng; train
steps draw dropout from their own generator, never from the noise's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..ops.topk import MAX_K, top_k, topk_lastdim

NEG = -1e30  # "never selected" sentinel (finite to keep arithmetic NaN-free)


@dataclasses.dataclass(frozen=True)
class DecodeModel:
    """A captioner bound for decoding.

    ``step(it, feats, state, rng, logsoftmax, uniform_t, beam_width) ->
    (float32 [N, V+1] log-probs or logits, state)``: one plain step; ``rng``
    is a ``torch.Generator`` in train mode (dropout), None in eval;
    ``uniform_t=False`` asks for a per-row step ``t`` (staggered groups).
    ``step_topk(it, feats, state, rng, k, temp, unk_bias, unk_idx,
    beam_width) -> (top_lsm [N, k], top_ix [N, k], row_sum [N], ent [N],
    state)``: one step plus the fused vocab epilogue, used when set.
    ``beam_init(state, bdash)`` adds the ancestry table after lane
    replication; ``beam_reorder(state, flat_idx)`` gathers every leaf but
    the physical caches; without them beam rows are reordered by a plain
    gather.  ``init_state(batch, beam)``: ``beam`` is True for single-group
    beam search."""
    prepare: Callable  # (fc, att, att_masks, rng) -> feats
    init_state: Callable  # (batch, beam=False) -> state
    step: Callable
    seq_length: int
    vocab_plus: int  # V + 1
    bos_idx: int = 0
    eos_idx: int = 0
    pad_idx: int = 0
    unk_idx: Optional[int] = None
    bad_endings_ix: Tuple[int, ...] = ()
    beam_init: Optional[Callable] = None
    beam_reorder: Optional[Callable] = None
    shared_beam_feats: bool = False
    step_topk: Optional[Callable] = None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

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
    gather; the JAX engine's one-hot matmul is an exact TPU substitute),
    nested states (an ensemble's member states) included."""
    return {k: reorder_state(v, idx) if isinstance(v, dict)
            else v.index_select(0, idx) if torch.is_tensor(v) else v
            for k, v in tree.items()}


def _where_tree(mask, new, old):
    """Per-row select between two states: ``new`` where ``mask`` [N].  A
    leaf that a step updated in place (the same tensor in both) is kept;
    a host-int leaf of ``old`` broadcasts; a nested state (an ensemble's
    member states) is selected leaf by leaf."""
    out = {}
    for k, v in new.items():
        o = old[k]
        if isinstance(v, dict):
            out[k] = _where_tree(mask, v, o)
        elif v is o or not torch.is_tensor(v):
            out[k] = v
        else:
            m = mask.view((-1,) + (1,) * (v.dim() - 1))
            out[k] = torch.where(m, v, o)
    return out


def generator_draw(generator: torch.Generator):
    """``draw(kind, t, shape)`` from ``generator`` on its device: 'uniform'
    in [0, 1), 'gumbel' as ``jax.random.gumbel`` makes it from a uniform
    (-log(-log(u)), u at least the smallest normal float32)."""
    tiny = torch.finfo(torch.float32).tiny

    def draw(kind, t, shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        if kind == 'uniform':
            return u
        return -torch.log(-torch.log(u.clamp_min(tiny)))
    return draw


def _draw_fn(rng, device):
    if rng is None:
        rng = torch.Generator(device).manual_seed(0)
    if isinstance(rng, torch.Generator):
        return generator_draw(rng)
    return lambda kind, t, shape: rng(kind, t, shape).to(device)


def penalty_fn(length_penalty: str, max_length: int):
    """Beam length penalty from its '<type>_<alpha>' spec, for lengths up
    to ``max_length``."""
    if not length_penalty:
        return penalty_fn_dynamic('', 0.0, max_length)
    pen_type, alpha = length_penalty.split('_')
    return penalty_fn_dynamic(pen_type, float(alpha), max_length)


def penalty_fn_dynamic(pen_type: str, alpha: float, max_length: int):
    """``(length, logprobs) -> penalized``, computed in float32 as the JAX
    engine computes it with a traced float32 alpha.  The 'wu' divisor of
    each length up to ``max_length`` is made here, on the host, so a
    decode step reads nothing back from the device."""
    if not pen_type:
        return lambda length, logprobs: logprobs
    if pen_type == 'wu':
        a = torch.tensor(alpha, dtype=torch.float32)
        mods = [float(((5.0 + torch.tensor(float(n))) ** a)
                      / (torch.tensor(6.0) ** a))
                for n in range(max_length + 1)]

        def wu(length, logprobs):
            return logprobs / torch.full((), mods[length],
                                         dtype=torch.float32,
                                         device=logprobs.device)
        return wu
    if pen_type == 'avg':
        return lambda length, logprobs: logprobs / max(float(length), 1.0)
    raise ValueError('unknown length_penalty %s' % pen_type)


def _beam_dynamic_setup(dm: DecodeModel, opt: Dict[str, Any]):
    """(temperature, length-penalty fn, unk_bias, unk_idx) for the vocab
    epilogue: UNK suppression adds -1000 at ``unk_idx`` after the
    log-softmax."""
    temperature = float(opt.get('temperature', 1.0) or 1.0)
    # lengths up to L + 2: the fast body's exit bound looks two steps on
    length_penalty = penalty_fn(opt.get('length_penalty', '') or '',
                                dm.seq_length + 2)
    suppress = int(opt.get('suppress_UNK', 0) or 0)
    if suppress and dm.unk_idx is not None:
        return temperature, length_penalty, -1000.0, int(dm.unk_idx)
    return temperature, length_penalty, 0.0, -1


def _flag(opt, name, default=0):
    return int(opt.get(name, default) or default)


# ---------------------------------------------------------------------------
# step programs: a decode as a setup and a per-step body over one carry
# ---------------------------------------------------------------------------

def write_back(dst: Dict, src: Dict) -> None:
    """``dst[k] = src[k]`` for every key of ``src``: a tensor into
    ``dst[k]``'s own buffer (``copy_``; the same tensor is left alone), so
    its address stays; a nested dict (the model state) key by key; any
    other value rebound.  A tensor where ``dst`` holds no tensor of its
    shape and dtype raises: its buffer would be a new one."""
    for k, v in src.items():
        old = dst.get(k)
        if isinstance(v, dict):
            write_back(old, v)
        elif torch.is_tensor(v):
            if (not torch.is_tensor(old) or old.shape != v.shape
                    or old.dtype != v.dtype):
                raise ValueError(
                    'decode carry %r: a %s %s tensor where the carry holds '
                    '%s' % (k, v.dtype, tuple(v.shape),
                            'a %s %s tensor' % (old.dtype, tuple(old.shape))
                            if torch.is_tensor(old) else type(old).__name__))
            if v is not old:
                old.copy_(v)
        else:
            dst[k] = v


class Carry(dict):
    """What a decode loop carries from one step to the next: tensors, the
    model state (a dict), the static feats, and the exit flag ``go`` (a 0-d
    bool tensor).  ``fixed``: ``put`` writes every tensor back into its own
    buffer (``write_back``), so the addresses stay those of the first step,
    which a CUDA graph of the step reads and writes; else ``put`` rebinds
    (train mode, whose autograd graph keeps every step's tensors)."""

    def __init__(self, fixed: bool, **items):
        super().__init__(items)
        self.fixed = fixed

    def put(self, **items):
        if self.fixed:
            write_back(self, items)
        else:
            self.update(items)


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """A decode split for the eager loop and for ``engine.graphs``, which
    captures the setup as one CUDA graph and each step as another.

    ``setup(fc, att, att_masks) -> Carry``: prepare, the bos step and the
    carry's first values; ``body(carry, t)``: step t, which reads no
    tensor on the host, writes the carry back in place and leaves its
    exit test in ``carry['go']``; ``result(carry)``: the outputs (views of
    the carry); ``steps``: the most bodies a decode runs."""
    setup: Callable
    body: Callable
    result: Callable
    steps: int


def run_eager(prog: StepProgram, fc_feats, att_feats, att_masks) -> Carry:
    """Run ``prog`` step by step: after each body the host reads the exit
    flag, the decode's one sync a step (none after the last body).
    Returns the final carry."""
    carry = prog.setup(fc_feats, att_feats, att_masks)
    for t in range(prog.steps):
        prog.body(carry, t)
        if t + 1 < prog.steps and not bool(carry['go']):
            break
    return carry


# ---------------------------------------------------------------------------
# step constraints and the next word
# ---------------------------------------------------------------------------

def _apply_step_constraints(lp, prev_tok, has_prev, dm: DecodeModel,
                            decoding_constraint: int,
                            remove_bad_endings: int):
    """-inf at each row's previous token (``decoding_constraint``) and at
    column 0 after a bad-ending word (``remove_bad_endings``), on the rows
    where ``has_prev`` (a bool, or a [N] bool tensor for per-row steps)."""
    bad_endings = remove_bad_endings and dm.bad_endings_ix
    if not (decoding_constraint or bad_endings):
        return lp
    N = lp.shape[0]
    hp = torch.as_tensor(has_prev, device=lp.device).expand(N)
    lp = lp.clone()
    if decoding_constraint:
        rows = torch.arange(N, device=lp.device)
        lp[rows, prev_tok] += torch.where(hp, -torch.inf, 0.0)
    if bad_endings:
        bad = torch.zeros(dm.vocab_plus, dtype=torch.bool, device=lp.device)
        bad[list(dm.bad_endings_ix)] = True
        lp[:, 0] += torch.where(hp & bad[prev_tok], -torch.inf, 0.0)
    return lp


def _unk_adjust(lsm, unk_bias: float, unk_idx: int):
    if unk_idx < 0:
        return lsm
    lsm = lsm.clone()
    lsm[:, unk_idx] += unk_bias
    return lsm


def _trigram_penalty(logprobs, seq_buf, t):
    """Trigram blocking: at step t >= 3 every w completing (seq[t-2],
    seq[t-1], w) as a trigram already ending at positions 2..t-1 takes
    -0.693 * 2 per occurrence.  ``seq_buf`` [N, L] holds the tokens so far
    (zeros from t on); ``t`` is a host int or a [N] tensor (per-row
    steps)."""
    N, L = seq_buf.shape
    dev = seq_buf.device
    pos = torch.arange(L, device=dev)
    prefix1 = seq_buf[:, (pos - 2).clamp_min(0)]
    prefix2 = seq_buf[:, (pos - 1).clamp_min(0)]
    t_arr = torch.as_tensor(t, device=dev).expand(N)[:, None]
    cur1 = torch.gather(seq_buf, 1, (t_arr - 2).clamp_min(0))
    cur2 = torch.gather(seq_buf, 1, (t_arr - 1).clamp_min(0))
    valid = (pos[None] >= 2) & (pos[None] <= t_arr - 1)
    match = (prefix1 == cur1) & (prefix2 == cur2) & valid
    counts = torch.zeros_like(logprobs).scatter_add_(
        1, seq_buf, match.to(logprobs.dtype))
    return torch.where(t_arr >= 3, counts * (-0.693 * 2.0), 0.0)


def sample_next_word(logprobs, sample_method: str, temperature: float,
                     draw, t):
    """(token [N], its logprob [N]) of one step: greedy; 'gumbel' (argmax
    of the tempered log-softmax of logprobs plus gumbel noise made from a
    uniform draw); else the categorical over logprobs / temperature, top-k
    ('top<k>') or nucleus ('top<p>', 0 < p < 1) masked, as ``argmax(lp +
    gumbel)``.  The JAX package's traced-method sampler computes the same
    function, one compiled program for every method."""
    if sample_method == 'greedy':
        it = logprobs.argmax(1)       # the first maximum, as jnp.argmax
        return it, logprobs.gather(1, it[:, None])[:, 0]
    if sample_method == 'gumbel':
        eps = 1e-20
        u = draw('uniform', t, logprobs.shape)
        g = -torch.log(-torch.log(u + eps) + eps)
        y = torch.log_softmax((logprobs + g) / temperature, dim=-1)
        it = y.argmax(1)
        return it, logprobs.gather(1, it[:, None])[:, 0]
    lp = logprobs / temperature
    if sample_method.startswith('top'):
        top_num = float(sample_method[3:])
        if 0 < top_num < 1:
            # nucleus: keep the most probable words up to mass top_num
            probs = torch.softmax(lp, dim=1)
            sorted_probs, order = torch.sort(probs, dim=1, descending=True,
                                             stable=True)
            mask = torch.cumsum(sorted_probs, dim=1) < top_num
            mask = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]], 1)
            kept = sorted_probs * mask
            kept = kept / kept.sum(1, keepdim=True)
            # back to vocab order
            lp = torch.empty_like(kept).scatter_(
                1, order, torch.log(kept.clamp_min(1e-38)))
        else:
            k = int(top_num)
            kth = torch.sort(lp, dim=1).values[:, -k][:, None]
            lp = torch.where(lp >= kth, lp, NEG)
    it = (lp + draw('gumbel', t, lp.shape)).argmax(1)
    return it, lp.gather(1, it[:, None])[:, 0]


# ---------------------------------------------------------------------------
# sample (greedy / temperature / top-k / top-p / gumbel)
# ---------------------------------------------------------------------------

def sample(dm: DecodeModel, fc_feats, att_feats, att_masks, rng,
           opt: Dict[str, Any], return_stats: bool = True,
           generator: Optional[torch.Generator] = None):
    """Returns (seq [B*n, L] int64, {'ent_sum', 'lp_sum'} [B*n]): the
    entropy and chosen-logprob sums of the step distributions, carried,
    stopping once every row has finished; or with ``return_stats=False``
    (the JAX engine's default) (seq, seqLogprobs [B*n, L, V+1] float32, the
    constrained step distributions, zeroed after each row's finish; the
    caller's autograd graph runs through them).  Beam options route to
    ``sample_beam`` (the winners' replayed tables without
    ``return_stats``, the carried beam sums with it), ``group_size > 1``
    to ``diverse_sample``.  ``rng``: the sampling noise (module doc).
    ``generator`` is the model's train switch, as in ``scan_logprobs``:
    given, prepare and then each step draw dropout from it; one sequence a
    row draws in the order and shapes ``scan_logprobs`` draws them, so a
    recompute from the generator's earlier state gives the same
    activations.  A beam or diverse decode draws its masks over its own
    rows (beam lanes, staggered groups), which no recompute reproduces:
    ``scan_logprobs`` over its sequences takes a fresh draw."""
    sample_method = opt.get('sample_method', 'greedy') or 'greedy'
    beam_size = _flag(opt, 'beam_size', 1)
    if beam_size > 1 and sample_method in ('greedy', 'beam_search'):
        seq, out, _ = sample_beam(dm, fc_feats, att_feats, att_masks, rng,
                                  opt, want_logps=not return_stats,
                                  generator=generator)
        return seq, out
    if _flag(opt, 'group_size', 1) > 1:
        return diverse_sample(dm, fc_feats, att_feats, att_masks, rng, opt,
                              generator)
    prog = sample_program(dm, opt, rng, return_stats, generator)
    if return_stats:
        return prog.result(run_eager(prog, fc_feats, att_feats, att_masks))
    carry = prog.setup(fc_feats, att_feats, att_masks)
    tables = [prog.body(carry, t) for t in range(prog.steps)]
    return carry['seq'], torch.stack(tables, 1)


def sample_program(dm: DecodeModel, opt: Dict[str, Any], rng=None,
                   return_stats: bool = True,
                   generator: Optional[torch.Generator] = None
                   ) -> StepProgram:
    """``sample``'s loop at one group, as a ``StepProgram``: the carry
    holds the last token, the unfinished rows, the sequence buffer and the
    two sums; with ``return_stats`` the body leaves ``go`` = some row is
    unfinished (the exact early exit), without it the body returns the
    step's kept table.  Greedy stats with no constraint take the fused
    ``k = 1`` vocab epilogue when the model has ``step_topk``.  The carry
    is fixed unless ``generator`` (train mode) is given."""
    sample_method = opt.get('sample_method', 'greedy') or 'greedy'
    temperature = float(opt.get('temperature', 1.0) or 1.0)
    sample_n = _flag(opt, 'sample_n', 1)
    # 0 (the margin losses' logits) must stay 0: no ``_flag``
    output_logsoftmax = int(opt.get('output_logsoftmax', 1))
    decoding_constraint = _flag(opt, 'decoding_constraint')
    block_trigrams = _flag(opt, 'block_trigrams')
    remove_bad_endings = _flag(opt, 'remove_bad_endings')
    L = dm.seq_length
    # greedy stats need only argmax + two scalars per row: with no
    # constraint in the way, the fused k = 1 epilogue gives exactly those
    fused_greedy = (return_stats and generator is None
                    and dm.step_topk is not None
                    and sample_method == 'greedy' and output_logsoftmax
                    and not decoding_constraint and not block_trigrams
                    and not remove_bad_endings)

    def setup(fc_feats, att_feats, att_masks):
        feats = dm.prepare(fc_feats, att_feats, att_masks, generator)
        if not dm.shared_beam_feats:
            feats = repeat_tree(sample_n, feats)
        N = fc_feats.shape[0] * sample_n
        dev = att_feats.device if att_feats is not None else fc_feats.device
        # greedy draws nothing
        draw = None if sample_method == 'greedy' else _draw_fn(rng, dev)
        return Carry(generator is None, feats=feats, draw=draw,
                     state=dm.init_state(N),
                     it=torch.full((N,), dm.bos_idx, dtype=torch.long,
                                   device=dev),
                     unfinished=torch.ones(N, dtype=torch.bool, device=dev),
                     seq=torch.zeros(N, L, dtype=torch.long, device=dev),
                     ent_sum=torch.zeros(N, dtype=torch.float32, device=dev),
                     lp_sum=torch.zeros(N, dtype=torch.float32, device=dev),
                     go=torch.ones((), dtype=torch.bool, device=dev))

    def body(c: Carry, t: int):
        it = c['it']
        if fused_greedy:
            # eval stats and the argmax are taken on the untempered
            # log-softmax
            tv, ti, _, en, state = dm.step_topk(it, c['feats'], c['state'],
                                                None, 1, 1.0, 0.0, -1, 0)
            nxt, chosen = ti[:, 0], tv[:, 0]
        else:
            logprobs, state = dm.step(it, c['feats'], c['state'], generator,
                                      bool(output_logsoftmax),
                                      uniform_t=True)
            # it == seq[:, t-1] for t >= 1
            logprobs = _apply_step_constraints(
                logprobs, it, t > 0, dm, decoding_constraint,
                remove_bad_endings)
            if block_trigrams:
                logprobs = logprobs + _trigram_penalty(logprobs, c['seq'], t)
            nxt, _ = sample_next_word(logprobs.detach(), sample_method,
                                      temperature, c['draw'], t)
            if return_stats:
                en = -(logprobs.exp() * logprobs).sum(-1)
                chosen = logprobs.gather(1, nxt[:, None])[:, 0]
        # every row is unfinished at t = 0
        keep = c['unfinished']
        nxt = torch.where(keep, nxt, dm.pad_idx)
        # all new values first: ``keep`` is the carry's own buffer
        new = dict(state=state, it=nxt,
                   unfinished=keep & (nxt != dm.eos_idx))
        table = None
        if return_stats:
            new.update(ent_sum=c['ent_sum'] + torch.where(keep, en, 0.0),
                       lp_sum=c['lp_sum'] + torch.where(keep, chosen, 0.0),
                       # EXACT early exit: once every row has finished, the
                       # remaining steps only write pads and gated-off stats
                       go=new['unfinished'].any())
        else:
            table = torch.where(keep[:, None], logprobs, 0.0)
        c['seq'][:, t] = nxt
        c.put(**new)
        return table

    def result(c: Carry):
        return c['seq'], {'ent_sum': c['ent_sum'], 'lp_sum': c['lp_sum']}

    return StepProgram(setup, body, result, L)


def scan_logprobs(dm: DecodeModel, fc_feats, att_feats, att_masks, gen_seq,
                  generator: Optional[torch.Generator] = None,
                  sample_n: int = 1, output_logsoftmax: int = 1):
    """The per-step distributions [N, L, V+1] of the model fed ``gen_seq``
    [N, L] (bos, then gen_seq[:, :-1]), zeroed after each row's finish as
    ``sample`` stores them: step t is kept while no token before t was eos
    or pad.  ``generator`` is the model's train switch: given, the steps
    draw dropout from it (the caller builds the autograd graph).

    Drawn from the generator's state before a one-sequence-a-row
    ``sample``, the masks are that pass's own, so the activations (and the
    gradient) are the sampling forward's.  A sequence from a train-mode
    beam (``train_beam_size > 1``) or diverse decode had its masks drawn
    over beam lanes or staggered groups, which no single-row recompute can
    reproduce: under dropout the recompute takes a fresh draw of the same
    sequence, the reference's REINFORCE estimand but not its per-mask
    gradient (the JAX ``scan_logprobs`` CAVEAT)."""
    L = dm.seq_length
    feats = dm.prepare(fc_feats, att_feats, att_masks, generator)
    if not dm.shared_beam_feats:
        feats = repeat_tree(sample_n, feats)
    N = fc_feats.shape[0] * sample_n
    state = dm.init_state(N)
    gen_seq = gen_seq.long()
    inputs = torch.cat([torch.full_like(gen_seq[:, :1], dm.bos_idx),
                        gen_seq[:, :-1]], 1)
    outs = []
    for t in range(L):
        lp, state = dm.step(inputs[:, t], feats, state, generator,
                            bool(output_logsoftmax), uniform_t=True)
        outs.append(lp)
    return torch.where(_keep_mask(gen_seq, dm)[..., None],
                       torch.stack(outs, 1), 0.0)


def _keep_mask(seqs, dm: DecodeModel):
    """[N, L] bool: step t counts while no token before t is eos / pad."""
    alive = (seqs[:, :-1] != dm.pad_idx) & (seqs[:, :-1] != dm.eos_idx)
    keep = torch.cat([torch.ones_like(alive[:, :1]), alive], 1)
    return torch.cumprod(keep.long(), 1).bool()


# ---------------------------------------------------------------------------
# beam search: one group, the table work fused at write time
# ---------------------------------------------------------------------------

def _gather(x, ix):
    """take_along_axis(x, ix, axis=1) for [B, R(, ...)] tables."""
    if x.dim() == 2:
        return torch.gather(x, 1, ix)
    return torch.gather(x, 1, ix[..., None].expand(-1, -1, x.shape[2]))


def beam_program(dm: DecodeModel, opt: Dict[str, Any],
                 generator: Optional[torch.Generator] = None,
                 feats=None) -> StepProgram:
    """Single-group beam search without the scatter constraints, with its
    prepare and bos step, as a ``StepProgram`` over a fixed carry.

    With ``dm.step_topk`` (fused): the bos step gives the vocab epilogue's
    top-``bdash`` (UNK-adjusted, temperature 1), and each step carries
    per-row top-``bdash`` survivors ``tv_c`` / ``ti_c``.  Without it: the
    bos step gives the float32 log-softmax [B, V+1], and each step carries
    the full candidate table ``cand`` = ``lsm' + beam sum`` [B*bdash, V+1]
    (``_finish_table``).  Body t runs the model step of the lanes chosen at
    t - 1 (none at t = 0), then the selection, the finished-beam pool merge
    and the exit test.  ``result`` gives (seq, {'ent_sum', 'lp_sum'}, done)
    as ``sample_beam`` returns them, ``done`` the finished-beam pool as
    {'seq' [B, 1, bdash, L], 'p', 'unaug_p', 'ent_sum', 'lp_sum' [B, 1,
    bdash]}, sorted descending by ``p``.

    ``generator`` (train mode): the bos step and every step draw dropout
    from it, on the eval beam's route where the model's step can take it
    (the transformer's self-attention leaves B1 for the plain ancestry
    attend: ``models/transformer.py``); the carry is rebound, not written
    back.  ``feats``: the prepared features (a train-mode ``sample_beam``
    prepares once, for the beam and its replay), else setup prepares
    them."""
    temperature, length_penalty, unk_bias, unk_idx = _beam_dynamic_setup(
        dm, opt)
    bdash = _flag(opt, 'beam_size', 10)
    sample_n = _flag(opt, 'sample_n', 1)
    fused = dm.step_topk is not None
    use_anc = dm.beam_init is not None and dm.beam_reorder is not None
    step_bw = bdash if use_anc else 0
    L = dm.seq_length

    def setup(fc_feats, att_feats, att_masks):
        B = fc_feats.shape[0]
        NBG = B * bdash
        pf = (feats if feats is not None else
              dm.prepare(fc_feats, att_feats, att_masks, generator))
        state = dm.init_state(B, beam=True)
        it = torch.full((B,), dm.bos_idx, dtype=torch.long,
                        device=fc_feats.device)
        # the bos step's distribution is untempered (the reference applies
        # the temperature from the second step on)
        if fused:
            tv0, ti0, rs0, en0, state = dm.step_topk(
                it, pf, state, generator, bdash, 1.0, unk_bias, unk_idx, 0)
        else:
            lsm0, state = dm.step(it, pf, state, generator, True,
                                  uniform_t=True)
            lsm0 = _unk_adjust(lsm0, unk_bias, unk_idx)         # [B, V1]
            rs0 = lsm0.sum(-1)
            en0 = -(lsm0.exp() * lsm0).sum(-1)
        dev = rs0.device
        f32 = dict(dtype=torch.float32, device=dev)
        state = repeat_tree(bdash, state)
        if use_anc:
            state = dm.beam_init(state, bdash)
        # the beam lanes of one image share its feats row
        # (shared_beam_feats); one row a lane otherwise
        c = Carry(generator is None, feats=pf, state=state,
                  feats_per_beam=(pf if dm.shared_beam_feats
                                  else repeat_tree(bdash, pf)))
        # t = 0: every lane holds the bos distribution; lane 0's candidates
        # are the bos ones, the other lanes are masked off
        lane0 = (torch.arange(bdash, device=dev) == 0).view(1, bdash, 1)
        if fused:
            # lane 0's top-bdash is the global top-bdash
            c['tv_c'] = torch.where(lane0, tv0[:, None, :], NEG).reshape(
                NBG, bdash)
            # its own buffer: at B = 1 the reshape would be a view with a
            # stride of 0, which the step's write-back cannot fill
            c['ti_c'] = ti0[:, None, :].expand(B, bdash, bdash).reshape(
                NBG, bdash).contiguous()
        else:
            c['cand'] = (lsm0[:, None, :] + torch.where(lane0, 0.0, NEG)
                         ).reshape(NBG, lsm0.shape[1])
        c.update(
            row_sum=rs0[:, None].expand(B, bdash).contiguous(),
            ent_row=en0[:, None].expand(B, bdash).contiguous(),
            beam_seq=torch.zeros(B, bdash, L, dtype=torch.long, device=dev),
            beam_ucum=torch.zeros(B, bdash, **f32),
            beam_sums=torch.zeros(B, bdash, **f32),
            beam_ent=torch.zeros(B, bdash, **f32),
            beam_lpc=torch.zeros(B, bdash, **f32),
            pool_seq=torch.zeros(B, bdash, L, dtype=torch.long, device=dev),
            pool_p=torch.full((B, bdash), NEG, **f32),
            pool_unaug=torch.full((B, bdash), NEG, **f32),
            pool_ent=torch.zeros(B, bdash, **f32),
            pool_lpc=torch.zeros(B, bdash, **f32),
            sel_ix=torch.zeros(B, bdash, dtype=torch.long, device=dev),
            beam_ix=torch.zeros(B, bdash, dtype=torch.long, device=dev),
            base=torch.arange(B, device=dev)[:, None] * bdash,
            go=torch.ones((), dtype=torch.bool, device=dev))
        return c

    def body(c: Carry, t: int):
        B = c['beam_sums'].shape[0]
        if t:
            # ---- model step + vocab epilogue of the lanes chosen at t-1;
            # the reordered state is the step's input, and only the
            # step's output is written back into the carry ----
            flat_idx = (c['base'] + c['beam_ix']).view(-1)
            state = (dm.beam_reorder(c['state'], flat_idx) if use_anc
                     else reorder_state(c['state'], flat_idx))
            it = c['sel_ix'].view(B * bdash)
            if fused:
                tv, ti, rs, en, state = dm.step_topk(
                    it, c['feats_per_beam'], state, generator, bdash,
                    temperature, unk_bias, unk_idx, step_bw)
                c.put(state=state, tv_c=tv, ti_c=ti,
                      row_sum=rs.view(B, bdash), ent_row=en.view(B, bdash))
            else:
                logits, state = dm.step(it, c['feats_per_beam'], state,
                                        generator, False, uniform_t=True,
                                        beam_width=step_bw)
                # the last selection has read the old table
                cand, rs, en = _finish_table(
                    torch.log_softmax(logits / temperature, dim=-1),
                    c['beam_sums'], unk_bias, unk_idx, c['cand'])
                c.put(state=state, cand=cand, row_sum=rs, ent_row=en)

        beam_sums = c['beam_sums']
        if fused:
            # ---- selection over the per-row survivors + the beam-sum
            # shift; entries are (beam, rank)-ordered, so flat ties resolve
            # to the lowest beam, then the lowest vocab index ----
            cand_s = (c['tv_c'].view(B, bdash, bdash) + beam_sums[:, :, None]
                      ).view(B, bdash * bdash)
            ys, jx = top_k(cand_s, bdash)
            beam_ix = jx // bdash
            sel_ix = torch.gather(c['ti_c'].reshape(B, bdash * bdash), 1, jx)
        else:
            # ---- selection over the full candidate table (the beam sums
            # are already in it); flat ties go to the lowest beam, then
            # the lowest vocab index ----
            V1 = c['cand'].shape[1]
            ys, ix = topk_lastdim(c['cand'].view(B, bdash * V1), bdash)
            beam_ix = ix // V1
            sel_ix = ix % V1

        new_seq = _gather(c['beam_seq'], beam_ix)
        new_seq[:, :, t] = sel_ix
        new_ucum = (_gather(c['beam_ucum'], beam_ix)
                    + _gather(c['row_sum'], beam_ix))
        new_ent = (_gather(c['beam_ent'], beam_ix)
                   + _gather(c['ent_row'], beam_ix))
        # chosen-token logprob: the candidate minus the parent's sum
        new_lpc = _gather(c['beam_lpc'], beam_ix) + (
            ys - _gather(beam_sums, beam_ix))

        # ---- finished-beam pool merge; pool entries precede candidates,
        # so ties keep the pool entry ----
        just_ended = (sel_ix == dm.eos_idx) | (t == L - 1)
        cand_p = torch.where(just_ended, length_penalty(t + 1, ys), NEG)
        top_p, top_i = top_k(torch.cat([c['pool_p'], cand_p], 1), bdash)
        c.put(pool_p=top_p,
              pool_unaug=_gather(torch.cat([c['pool_unaug'], new_ucum], 1),
                                 top_i),
              pool_seq=_gather(torch.cat([c['pool_seq'], new_seq], 1), top_i),
              pool_ent=_gather(torch.cat([c['pool_ent'], new_ent], 1), top_i),
              pool_lpc=_gather(torch.cat([c['pool_lpc'], new_lpc], 1), top_i),
              beam_sums=ys - 1000.0 * just_ended, beam_seq=new_seq,
              beam_ucum=new_ucum, beam_ent=new_ent, beam_lpc=new_lpc,
              sel_ix=sel_ix, beam_ix=beam_ix)

        # ---- EXACT early exit: stop once no image's pool can change.
        # A future candidate's raw sum is bounded by the current best lane
        # sum (log-probs <= 0), its penalized score by that sum at the
        # lengths t+2..L (t+1 too, for a length-decreasing penalty); when
        # that cannot strictly beat the worst pool entry, the pool is
        # final.  Tested before the next model step, whose output the exit
        # would discard. ----
        if t + 1 >= L:
            c.put(go=torch.zeros((), dtype=torch.bool, device=ys.device))
            return
        max_sums = c['beam_sums'].max(1).values
        bound = torch.maximum(
            torch.maximum(length_penalty(L, max_sums),
                          length_penalty(t + 3, max_sums)),
            length_penalty(t + 2, max_sums))
        c.put(go=(bound > c['pool_p'].min(1).values).any())

    def result(c: Carry):
        done = {'seq': c['pool_seq'][:, None], 'p': c['pool_p'][:, None],
                'unaug_p': c['pool_unaug'][:, None],
                'ent_sum': c['pool_ent'][:, None],
                'lp_sum': c['pool_lpc'][:, None]}
        return _pick(done, sample_n) + (done,)

    return StepProgram(setup, body, result, L)


def _pick(done, sample_n: int):
    """(seq, {'ent_sum', 'lp_sum'}) of the pools [B, G, bdash, ...]: the
    best beam of group 0 (``sample_n`` 1) or group 0's bdash beams."""
    B, _, _, L = done['seq'].shape
    if sample_n == 1:
        return (done['seq'][:, 0, 0],
                {k: done[k][:, 0, 0] for k in ('ent_sum', 'lp_sum')})
    return (done['seq'][:, 0].reshape(B * sample_n, L),
            {k: done[k][:, 0].reshape(B * sample_n)
             for k in ('ent_sum', 'lp_sum')})


def _finish_table(lsm, sums, unk_bias: float, unk_idx: int, out):
    """The plain branch's pass over a fresh [B*bdash, V+1] log-softmax
    table: UNK adjust, the two carried-stat reductions and the candidate
    add for the next selection, written into ``out`` (the carry's table:
    no copy of it a step)."""
    B, bdash = sums.shape
    lsm = _unk_adjust(lsm, unk_bias, unk_idx)
    row_sum = lsm.sum(-1)
    ent_row = -(lsm.exp() * lsm).sum(-1)
    cand = torch.add(lsm, sums.reshape(-1, 1), out=out)
    return cand, row_sum.view(B, bdash), ent_row.view(B, bdash)


# ---------------------------------------------------------------------------
# beam search: the general body (diverse groups, constraints)
# ---------------------------------------------------------------------------

def beam_search(dm: DecodeModel, init_logprobs, init_state, feats_per_beam,
                opt: Dict[str, Any],
                generator: Optional[torch.Generator] = None):
    """Batched (diverse) beam search, the general body.

    init_logprobs: [B, V+1] log-softmax of the bos step; init_state: the
    state of batch B after it; feats_per_beam: the feats of B*G*bdash rows
    (B*G blocks for a shared-feats model).  Returns the finished-beam pools
    {'seq' [B, G, bdash, L], 'p', 'unaug_p', 'ent_sum', 'lp_sum' [B, G,
    bdash]}, each group's sorted descending by ``p``.

    Group g runs its local step t - g at global step t.  Within a step the
    groups' table math runs one group after another (group g's diversity
    penalty reads the tokens earlier groups chose at its local time, after
    their update); the model step is batched over every group.  A group
    outside its window [0, L-1] is frozen: its table work is skipped, its
    rows are stepped with any token (the identity reorder and token 0) and
    every state leaf is selected back.  The physical K/V caches that the
    step writes in place are not: such a row writes at its frozen ``t``,
    before its start the slot its first step overwrites, after its finish
    slot L + 1, which no row reads (or no slot at all: the write is
    dropped past the cache).  ``generator`` (train mode): each model step
    draws dropout from it."""
    temperature, length_penalty, unk_bias, unk_idx = _beam_dynamic_setup(
        dm, opt)
    beam_size = _flag(opt, 'beam_size', 10)
    G = _flag(opt, 'group_size', 1)
    diversity_lambda = float(opt.get('diversity_lambda', 0.5))
    decoding_constraint = _flag(opt, 'decoding_constraint')
    remove_bad_endings = _flag(opt, 'remove_bad_endings')
    bdash = beam_size // G
    if bdash > MAX_K:
        raise ValueError('beam search over %d beams a group: the selection '
                         'kernel (ops.topk.topk_lastdim) takes k <= %d'
                         % (bdash, MAX_K))
    B, V1 = init_logprobs.shape
    L = dm.seq_length
    NBG = B * G * bdash
    dev = init_logprobs.device
    f32 = dict(dtype=torch.float32, device=dev)
    use_anc = dm.beam_init is not None and dm.beam_reorder is not None

    state = repeat_tree(G * bdash, init_state)
    if use_anc:
        state = dm.beam_init(state, bdash)
    # every (group, beam) lane starts from the bos distribution
    tables = [init_logprobs.repeat_interleave(bdash, 0)] * G

    def zeros():
        return torch.zeros(B, bdash, **f32)

    def negs():
        return torch.full((B, bdash), NEG, **f32)

    seqs = [torch.zeros(B, bdash, L, dtype=torch.long, device=dev)
            for _ in range(G)]
    ucum, sums, ent, lpc = ([zeros() for _ in range(G)] for _ in range(4))
    pseq = [torch.zeros(B, bdash, L, dtype=torch.long, device=dev)
            for _ in range(G)]
    pp, pu = [negs() for _ in range(G)], [negs() for _ in range(G)]
    pent, plpc = [zeros() for _ in range(G)], [zeros() for _ in range(G)]
    lanes = torch.arange(bdash, device=dev)
    identity = lanes[None].expand(B, bdash)
    base = (torch.arange(B, device=dev)[:, None, None] * G
            + torch.arange(G, device=dev)[None, :, None]) * bdash

    for t in range(L + G - 1):
        sel_list, beamix_list, active = [], [], []
        for g in range(G):
            lt = t - g
            active.append(0 <= lt <= L - 1)
            if not active[-1]:
                sel_list.append(torch.zeros_like(identity))
                beamix_list.append(identity)
                continue
            # ---- constraints ----
            lp = _apply_step_constraints(
                tables[g], seqs[g].view(B * bdash, L)[:, max(lt - 1, 0)],
                lt > 0, dm, decoding_constraint, remove_bad_endings)
            lp = _unk_adjust(lp, unk_bias, unk_idx)
            unaug_lp = lp.view(B, bdash, V1)
            # ---- diversity penalty: each token the earlier groups' beams
            # chose at this local time, counted per image ----
            lp3 = unaug_lp
            if g > 0:
                toks = torch.cat([seqs[i][:, :, lt] for i in range(g)], 1)
                change = torch.zeros(B, V1, **f32).scatter_add_(
                    1, toks, torch.ones(toks.shape, **f32))
                lp3 = unaug_lp - diversity_lambda * change[:, None, :]
            # ---- beam step ----
            first_mask = torch.where((lt == 0) & (lanes > 0), NEG, 0.0)
            candidates = (sums[g] + first_mask)[..., None] + lp3
            ys, ix = topk_lastdim(candidates.view(B, bdash * V1), bdash)
            beam_ix = ix // V1
            sel_ix = ix % V1

            new_seq = _gather(seqs[g], beam_ix)
            new_seq[:, :, lt] = sel_ix
            new_ucum = (_gather(ucum[g], beam_ix)
                        + _gather(unaug_lp.sum(-1), beam_ix))
            ent_row = -(unaug_lp.exp() * unaug_lp).sum(-1)
            new_ent = _gather(ent[g], beam_ix) + _gather(ent_row, beam_ix)
            chosen_lp = torch.gather(unaug_lp.view(B, bdash * V1), 1,
                                     beam_ix * V1 + sel_ix)
            new_lpc = _gather(lpc[g], beam_ix) + chosen_lp

            # ---- finished-beam pool merge ----
            just_ended = (sel_ix == dm.eos_idx) | (lt == L - 1)
            cand_p = torch.where(just_ended, length_penalty(lt + 1, ys), NEG)
            top_p, top_i = top_k(torch.cat([pp[g], cand_p], 1), bdash)
            pp[g] = top_p
            pu[g] = _gather(torch.cat([pu[g], new_ucum], 1), top_i)
            pseq[g] = _gather(torch.cat([pseq[g], new_seq], 1), top_i)
            pent[g] = _gather(torch.cat([pent[g], new_ent], 1), top_i)
            plpc[g] = _gather(torch.cat([plpc[g], new_lpc], 1), top_i)
            sums[g] = ys - 1000.0 * just_ended
            seqs[g], ucum[g], ent[g], lpc[g] = (new_seq, new_ucum, new_ent,
                                                new_lpc)
            sel_list.append(sel_ix)
            beamix_list.append(beam_ix)

        if t == L + G - 2:
            break          # the last step's model output is never read
        # ---- the model step, batched over every group ----
        state_ix = (base + torch.stack(beamix_list, 1)).view(-1)
        it = torch.stack(sel_list, 1).view(NBG)
        new_state = (dm.beam_reorder(state, state_ix) if use_anc
                     else reorder_state(state, state_ix))
        logits, stepped = dm.step(it, feats_per_beam, new_state, generator,
                                  False, uniform_t=(G == 1),
                                  beam_width=bdash if use_anc else 0)
        new_tables = torch.log_softmax(logits / temperature, dim=-1).view(
            B, G, bdash * V1)
        if all(active):
            state = stepped
        else:
            act = torch.tensor(active, device=dev)
            state = _where_tree(act[None, :, None].expand(B, G, bdash)
                                .reshape(-1), stepped, state)
        tables = [new_tables[:, g].reshape(B * bdash, V1) if active[g]
                  else tables[g] for g in range(G)]

    return {'seq': torch.stack(pseq, 1), 'p': torch.stack(pp, 1),
            'unaug_p': torch.stack(pu, 1), 'ent_sum': torch.stack(pent, 1),
            'lp_sum': torch.stack(plpc, 1)}


def replay_beam_logps(dm: DecodeModel, feats, seqs, opt: Dict[str, Any],
                      generator: Optional[torch.Generator] = None):
    """The per-step constrained distributions [N, L, V+1] of given beam
    winners ``seqs`` [N, L] (``feats`` of N rows, or N / n for a
    shared-feats model): step 0 the bos step's log-softmax, later steps
    ``log_softmax(logits / temperature)`` as the beam loop tempered them,
    then the beam's constraint masks and UNK suppression; zero past each
    winner's finish.  ``generator`` (train mode): the steps draw dropout
    from it (a fresh draw: not the beam's masks) and the caller's autograd
    graph runs through the tables."""
    temperature, _, unk_bias, unk_idx = _beam_dynamic_setup(dm, opt)
    decoding_constraint = _flag(opt, 'decoding_constraint')
    remove_bad_endings = _flag(opt, 'remove_bad_endings')
    N, L = seqs.shape
    state = dm.init_state(N)
    inputs = torch.cat([torch.full_like(seqs[:, :1], dm.bos_idx),
                        seqs[:, :-1]], 1)
    outs = []
    for t in range(L):
        # the input token at step t is seq[t-1] (bos at t = 0)
        it = inputs[:, t]
        logits, state = dm.step(it, feats, state, generator, False,
                                uniform_t=True)
        lp = torch.log_softmax(logits / temperature if t > 0 else logits,
                               dim=-1)
        lp = _apply_step_constraints(lp, it, t > 0, dm, decoding_constraint,
                                     remove_bad_endings)
        outs.append(_unk_adjust(lp, unk_bias, unk_idx))
    return torch.where(_keep_mask(seqs, dm)[..., None], torch.stack(outs, 1),
                       0.0)


def beam_fast(opt: Dict[str, Any]) -> bool:
    """Whether a beam decode takes ``beam_program`` (one group without the
    scatter constraints; ``_beam_general: 1`` forces the general body)."""
    return (_flag(opt, 'group_size', 1) == 1
            and not _flag(opt, 'decoding_constraint')
            and not _flag(opt, 'remove_bad_endings')
            and not _flag(opt, '_beam_general'))


def sample_beam(dm: DecodeModel, fc_feats, att_feats, att_masks, rng,
                opt: Dict[str, Any], want_logps: bool = False,
                generator: Optional[torch.Generator] = None):
    """Beam decode.  Returns (seq [B*sample_n, L], the winners' replayed
    distributions [B*sample_n, L, V+1] with ``want_logps``, else their
    carried {'ent_sum', 'lp_sum'} [B*sample_n], done) with ``done`` the
    finished-beam pools [B, G, bdash, ...]; ``sample_n`` is 1 (the best
    beam of group 0) or bdash (group 0's beams).  One group without the
    scatter constraints takes ``beam_program`` (``beam_fast``), the rest
    ``beam_search``.  Beam decoding draws no noise: ``rng`` is unused.

    ``generator`` is the train switch (the RL steps' ``train_beam_size >
    1``): prepare, the bos step and every beam step draw dropout from it on
    the eval beam's route (``beam_program``), the replay draws afresh.  The beam's tokens take no gradient, so its steps build no
    autograd graph; the replay's tables carry the caller's, back to the
    one prepare the beam read too."""
    beam_size = _flag(opt, 'beam_size', 10)
    group_size = _flag(opt, 'group_size', 1)
    sample_n = _flag(opt, 'sample_n', 1)
    bdash = beam_size // group_size
    if sample_n not in (1, bdash):
        raise ValueError('when beam search, sample_n == 1 or beam size')
    B = fc_feats.shape[0]
    feats = dm.prepare(fc_feats, att_feats, att_masks, generator)
    with torch.no_grad():
        if beam_fast(opt):
            prog = beam_program(dm, opt, generator, feats)
            seq, stats, done = prog.result(
                run_eager(prog, fc_feats, att_feats, att_masks))
        else:
            # staggered groups step rows at different t
            state = dm.init_state(B, beam=(group_size == 1))
            it = torch.full((B,), dm.bos_idx, dtype=torch.long,
                            device=fc_feats.device)
            # the bos step's distribution is untempered
            init, state = dm.step(it, feats, state, generator, True,
                                  uniform_t=True)
            # the beam lanes of one (image, group) share its feats row
            # (shared_beam_feats); by the effective beam count otherwise
            feats_per_beam = repeat_tree(
                group_size if dm.shared_beam_feats else group_size * bdash,
                feats)
            done = beam_search(dm, init, state, feats_per_beam, opt,
                               generator)
            seq, stats = _pick(done, sample_n)
    if not want_logps:
        return seq, stats, done
    replay_feats = (feats if sample_n == 1 or dm.shared_beam_feats
                    else repeat_tree(sample_n, feats))
    return seq, replay_beam_logps(dm, replay_feats, seq, opt,
                                  generator), done


# ---------------------------------------------------------------------------
# diverse sampling (group-staggered sampling, not beam)
# ---------------------------------------------------------------------------

def diverse_sample(dm: DecodeModel, fc_feats, att_feats, att_masks, rng,
                   opt: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
    """Returns (seq [B*G, L], the sampled tokens' logprobs [B*G, L]).

    Groups are folded into the batch (row b*G + g) and staggered in time:
    group g samples its local step t - g at global step t, so one batched
    model call per global step serves every group, each row at its own
    ``t``; a group outside its window is stepped and selected back.  The
    diversity penalty is pooled over the batch: every token that any row
    of an earlier group chose at this group's local time is penalized
    once for every row, once for each such group.  Constraints and the
    trigram block act at each group's local time; a row stops (pads) once
    its previous token is eos or pad.  ``generator`` (train mode): prepare
    and each step draw dropout from it, and the sampled tokens' logprobs
    carry the caller's autograd graph."""
    sample_method = opt.get('sample_method', 'greedy') or 'greedy'
    temperature = float(opt.get('temperature', 1.0) or 1.0)
    G = _flag(opt, 'group_size', 1)
    diversity_lambda = float(opt.get('diversity_lambda', 0.5))
    decoding_constraint = _flag(opt, 'decoding_constraint')
    block_trigrams = _flag(opt, 'block_trigrams')
    remove_bad_endings = _flag(opt, 'remove_bad_endings')
    B = fc_feats.shape[0]
    L = dm.seq_length
    V1 = dm.vocab_plus
    dev = att_feats.device if att_feats is not None else fc_feats.device
    draw = _draw_fn(rng, dev)

    feats = dm.prepare(fc_feats, att_feats, att_masks, generator)
    feats_g = feats if dm.shared_beam_feats else repeat_tree(G, feats)
    state = dm.init_state(B * G)
    seq_tbl = torch.zeros(B, G, L, dtype=torch.long, device=dev)
    lp_tbl = torch.zeros(B, G, L, dtype=torch.float32, device=dev)
    it_tbl = torch.full((B, G), dm.bos_idx, dtype=torch.long, device=dev)

    # group g is active for t in [g, L+g-1]: L+G-1 steps cover them all
    for t in range(L + G - 1):
        local_t = [t - g for g in range(G)]
        active = [0 <= x <= L - 1 for x in local_t]
        # a group outside its window reads some column: its result is
        # selected away
        lt = [min(max(x, 0), L - 1) for x in local_t]
        logits, new_state = dm.step(it_tbl.reshape(B * G), feats_g, state,
                                    generator, False, uniform_t=False)
        lp4 = torch.log_softmax(logits / temperature, dim=-1).view(B, G, V1)

        # diversity: n_chosen[gt, v] = the earlier groups gs < gt of which
        # some row chose v at gt's local time
        n_chosen = torch.zeros(G, V1, dtype=torch.float32, device=dev)
        for gt in range(1, G):
            for gs in range(gt):
                chosen = torch.zeros(V1, dtype=torch.bool, device=dev)
                chosen[seq_tbl[:, gs, lt[gt]]] = True
                n_chosen[gt] += chosen
        lp4 = lp4 - diversity_lambda * n_chosen[None]

        lt_t = torch.tensor(lt, device=dev)
        prev_tok = torch.gather(seq_tbl, 2, (lt_t - 1).clamp_min(0)
                                .view(1, G, 1).expand(B, G, 1))[..., 0]
        has_prev = torch.tensor([x > 0 for x in local_t], device=dev)
        lp = _apply_step_constraints(
            lp4.reshape(B * G, V1), prev_tok.reshape(-1),
            has_prev[None].expand(B, G).reshape(-1), dm,
            decoding_constraint, remove_bad_endings)
        if block_trigrams:
            lp = lp + _trigram_penalty(lp, seq_tbl.view(B * G, L),
                                       lt_t[None].expand(B, G).reshape(-1))
        it, sample_lp = sample_next_word(lp, sample_method, 1.0, draw, t)
        it, sample_lp = it.view(B, G), sample_lp.view(B, G)

        # unfinished recomputed from the sequence
        first = torch.tensor([x == 0 for x in local_t], device=dev)[None]
        unfinished = (prev_tok != dm.pad_idx) & (prev_tok != dm.eos_idx)
        it = torch.where(first | unfinished, it, dm.pad_idx)

        act = torch.tensor(active, device=dev)
        for g in range(G):
            if active[g]:
                seq_tbl[:, g, lt[g]] = it[:, g]
                lp_tbl[:, g, lt[g]] = sample_lp[:, g]
        it_tbl = torch.where(act[None], it, it_tbl)
        state = (new_state if all(active) else _where_tree(
            act[None].expand(B, G).reshape(-1), new_state, state))
    return seq_tbl.view(B * G, L), lp_tbl.view(B * G, L)
