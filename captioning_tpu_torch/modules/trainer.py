"""The train steps: XE, SCST, and the structure losses with PPO.

Port of ``captioning_tpu/modules/trainer.py``.  The JAX trainer is
functional (variables and optax state in, updated copies out, one jitted
program a step); here the captioner's parameters, its BatchNorm statistics
and the ``torch.optim`` state are updated in place.  ``opt_state_jax`` /
``load_opt_state_jax`` carry the optimizer state in the JAX package's
``optimizer.npz`` layout.

At any compute dtype the parameters, their gradients, the clip and the
optimizer's state are float32, as ``jax.value_and_grad`` over float32
params gives them to optax: a bf16 captioner computes with bf16 copies of
its float32 masters (``models.layers.compute_param``), each use's gradient
is cast back to float32 and the uses sum there, and each update ends by
rewriting the copies in place from the masters
(``Captioner.sync_compute_weights``; inside a graphed step's capture too).

The RL steps come in two forms, as in the JAX package.  The fused ones
(``sc_fused_step``, ``struc_fused_step``) sample, score on the card
(``ops/cider_device.py``) and differentiate the sampling pass itself.  The
unfused ones decode (``sc_decode``, ``struc_decode``), leave the scoring to
the host (``utils/rewards.py``, ``utils/cider_native.py``) and recompute
the sampled sequence's distributions in the grad step (``sc_grad_step``,
``struc_grad_step``).  Randomness:

* the sampling noise comes from its own ``rng`` (a generator or a
  ``draw`` callable, ``engine.decoding``);
* dropout comes from ``generator``, the train switch.  A decode draws from
  a copy and leaves ``generator`` as it found it, so the grad step, handed
  the same generator, draws the same masks in the same order (prepare,
  then each step) and recomputes the sampling pass's activations exactly;
* the structure steps' XE term draws from its own ``generator_lm``.

BatchNorm running statistics change once a step, from the sampling pass's
train-mode prepare, as the JAX steps thread them: the eval greedy baseline
reads them, and the XE term and the recompute run under
``Captioner.bn_frozen``.

Each step is a body that reads nothing on the host (the forward, the loss,
the backward into gradients kept from step to step, the clip and the
optimizer's update) behind the scalars it reads (``_scalars``: the
learning rate in the optimizer's param group and the scheduled-sampling
probability, 0-d tensors on the card).  The eager methods run the body;
the ``*_graphed`` ones (the counterparts of the JAX ``jax.jit`` steps) run
it as one CUDA graph (``engine.graphs.GraphTrainStep``), cached by the
step's kind, the options it bakes in, its input shapes and the generators
and scorer it reads.  ``graph_route`` says why a step stays eager.  The
fused SCST body runs the greedy baseline for all ``seq_length`` steps:
a graph cannot read the exit flag, and the steps after every row has
finished only write pads, so the tokens are the early exit's.

Under a data axis (``parallel.mesh``, world > 1) each rank steps on its
slice of the global batch, and the step is the one-device step over the
global batch, as under the JAX package's ``pjit``: the losses divide by
their denominators summed over the ranks (``losses``' ``denom``), so each
rank's loss is its share of the global loss; after the backward one SUM
all-reduce of the flat gradient (with the step's reported shares) gives
every rank the global gradient, which the clip then sees; drop-worst
selects from the global loss vector; the BatchNorm statistics are the
global batch's (the trainer gives each ``models.layers.MaskedBatchNorm``
the sum over the ranks as its ``reduce``).  The reported losses
are global and equal on every rank; the RL steps' per-row tokens and
rewards stay this rank's rows.  These steps run eagerly (``graph_route``).

Under a model axis (``mesh_shape data:D,model:M``, a captioner whose vocab
tensors ``Captioner.shard_vocab`` sharded) the M ranks of a model group
step on the same rows, so every one of those sums runs over the data group
only; the vocab-parallel pieces (``parallel/vocab.py``) give each rank the
full logits and the gradients of one process, the flat all-reduce sums a
shard's gradient over the ranks that hold the same shard, and the clip by
norm adds the shards' squares over the model group (a replicated tensor
counts once).
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from ..engine import decoding
from ..engine.graphs import CudaRecorder, GraphTrainStep
from ..models.layers import MaskedBatchNorm
from ..parallel import mesh
from ..utils import optimizers as optim_utils
from . import losses

# the graphed steps, by kind
KINDS = ('xe', 'sc_fused', 'sc_grad', 'struc_fused', 'struc_grad')


def _copy(generator: torch.Generator) -> torch.Generator:
    """A generator on the same device in the same state."""
    g = torch.Generator(generator.device)
    g.set_state(generator.get_state())
    return g


class Trainer:
    """The train steps of ``captioner`` with ``opt``'s optimizer;
    ``old_captioner`` is PPO's frozen old policy (eval, no graph)."""

    def __init__(self, captioner, opt, old_captioner=None):
        self.captioner = captioner.trainable()
        self.opt = opt
        self.old_captioner = old_captioner
        # whether the structure steps' sampling pass outputs log-softmaxed
        # tables (loss_wrapper.py:31-37): the margin losses take logits;
        # shared by the fused, decode and grad paths
        self.struc_out_ls = int(
            getattr(opt, 'struc_use_logsoftmax', False) or
            getattr(opt, 'structure_loss_type', '') == 'softmax_margin' or
            'margin' not in getattr(opt, 'structure_loss_type', ''))
        self.label_smoothing = float(getattr(opt, 'label_smoothing', 0) or 0)
        # the data axis: the losses' denominators and the BatchNorm
        # statistics are summed over its group (a model group's ranks read
        # the same rows)
        self.mesh = mesh.current()
        self.data = self.mesh.data
        group = self.mesh.data_group
        self._denom = (functools.partial(mesh.all_reduce_sum, group=group)
                       if self.data > 1 else None)
        if self.data > 1:
            for m in captioner.module.modules():
                if isinstance(m, MaskedBatchNorm):
                    m.reduce = functools.partial(mesh.all_reduce_grad,
                                                 group=group)
        self.named_params = dict(captioner.module.named_parameters())
        params = list(self.named_params.values())
        cuda = self.captioner.device.type == 'cuda'
        # on the card the optimizer keeps its step count and learning rate
        # on the device wherever torch.optim can (optimizers.CAPTURABLE)
        capturable = cuda and not optim_utils.graph_route(opt)
        if getattr(opt, 'noamopt', False):
            self.optimizer = optim_utils.build_noam_optimizer(
                opt, params, capturable)
        else:
            self.optimizer = optim_utils.build_optimizer(opt, params,
                                                         capturable)
        shards = captioner.vocab_shards
        self.clip = optim_utils.clip_transform(
            opt, [self.named_params[n] for n in shards],
            self.mesh.model_group)
        # the gradients live from here on and are zeroed in place each
        # step, so a graph's backward accumulates into the same buffers; a
        # parameter the pass does not reach (the folded cross-attention's K
        # bias in the transformer's decode step) keeps a zero gradient, as
        # jax.grad gives it, and the optimizer steps it as the JAX one
        for p in params:
            p.grad = torch.zeros_like(p)
        # the scheduled-sampling probability the XE body reads: on the
        # card a 0-d tensor that a graph reads at each replay
        self._ss = (torch.zeros((), device=self.captioner.device)
                    if cuda else 0.0)
        # (kind, baked options, input shapes, generators, scorer) ->
        # GraphTrainStep
        self._graphs = {}
        # the graphed steps' recorder class: None is CudaRecorder on a
        # CUDA captioner, the eager body on a CPU one (tests set
        # engine.graphs.EagerRecorder here to run the cache's plumbing)
        self.graph_recorder = None

    # -- optimizer state in the JAX layout ----------------------------------
    def opt_state_jax(self) -> Dict:
        """The optimizer state as ``optimizer.npz`` holds it, with full
        arrays: a model axis's shards gathered (every rank of a model
        group calls it)."""
        return optim_utils.state_to_jax(self.optimizer, self.opt,
                                        self.named_params,
                                        self.captioner.cfg,
                                        self.captioner.full_state)

    def load_opt_state_jax(self, flat) -> None:
        """Load full arrays, each sharded tensor's moments cut to this
        rank's rows."""
        optim_utils.state_from_jax(self.optimizer, self.opt,
                                   self.named_params, self.captioner.cfg,
                                   flat, self.captioner.local_state)

    # -- plumbing -----------------------------------------------------------
    def _scalars(self, lr, ss_prob=None):
        """The scalars a step body reads, set before it runs: the learning
        rate (into a capturable optimizer's device tensor) and the
        scheduled-sampling probability."""
        optim_utils.set_lr(self.optimizer, lr)
        if ss_prob is not None:
            if torch.is_tensor(self._ss):
                self._ss.fill_(ss_prob)
            else:
                self._ss = float(ss_prob)

    def _apply_updates(self, loss, **shares):
        """Backward, clip, step.  Returns {'loss': the loss, **shares}
        detached: under a data axis summed over the ranks with the gradient
        (one SUM all-reduce of one flat buffer), so the clip sees the
        global gradient and the returned values are the global ones."""
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        out = dict(loss=loss.detach(), **shares)
        params = list(self.named_params.values())
        if self.data > 1:
            grads = [p.grad for p in params]
            flat = torch.cat([g.reshape(-1) for g in grads] +
                             [v.reshape(1).to(grads[0].dtype)
                              for v in out.values()])
            flat = mesh.all_reduce_sum(flat, group=self.mesh.data_group)
            at = 0
            for g in grads:
                g.copy_(flat[at:at + g.numel()].view_as(g))
                at += g.numel()
            out = {k: flat[at + i].to(v.dtype)
                   for i, (k, v) in enumerate(out.items())}
        self.clip(params)
        self.optimizer.step()
        # the compute-dtype copies follow the masters, at their addresses
        self.captioner.sync_compute_weights()
        return out

    def _crit(self, logprobs, target, mask, reduction):
        if self.label_smoothing > 0:
            return losses.label_smoothing_criterion(
                logprobs, target, mask, self.label_smoothing, reduction,
                denom=self._denom)
        return losses.language_model_criterion(logprobs, target, mask,
                                               reduction, denom=self._denom)

    def _mean(self, x):
        """x.mean(), under a data axis this rank's share of the global
        mean (a reported value that ``_apply_updates`` sums)."""
        return losses._mean(x, self._denom)

    def _drop_worst(self, loss_vec, drop_worst_rate):
        """The mean of the k = int(N * (1 - rate)) smallest losses; under
        a data axis N and the selection are the global batch's, and this
        rank's share is the sum of its selected rows over k."""
        if self.data == 1:
            k = int(loss_vec.shape[0] * (1 - drop_worst_rate))
            return torch.topk(loss_vec, k, largest=False).values.mean()
        n = loss_vec.shape[0]
        group, index = self.mesh.data_group, self.mesh.data_index
        rows = torch.zeros(self.data, device=loss_vec.device)
        rows[index] = n
        rows = mesh.all_reduce_sum(rows, group).long().tolist()
        start = sum(rows[:index])
        every = loss_vec.new_zeros(sum(rows))
        every[start:start + n] = loss_vec.detach()
        every = mesh.all_reduce_sum(every, group)
        k = int(every.shape[0] * (1 - drop_worst_rate))
        pick = torch.topk(every, k, largest=False).indices
        mine = pick[(pick >= start) & (pick < start + n)] - start
        return loss_vec[mine].sum() / k

    # -- graphed steps ------------------------------------------------------
    def graph_route(self, kind: str) -> str:
        """'' when the step ``kind`` (``KINDS``) with this trainer's
        options runs as a CUDA graph (``<kind>_step_graphed``), else why
        it stays on the eager method."""
        if kind not in KINDS:
            raise ValueError('unknown train step kind %r' % kind)
        if self.captioner.vocab_shards:
            return ('model axis (model > 1): per-step collectives of the '
                    'vocab shards')
        if self.mesh.world > 1:
            return ('data-parallel (world > 1): the gradient all-reduce '
                    'runs between backward and step')
        why = optim_utils.graph_route(self.opt)
        if why:
            return why
        opt = self.opt
        if kind == 'sc_fused' and int(opt.sc_beam_size or 1) > 1:
            return 'a beam-search greedy baseline (sc_beam_size > 1)'
        if kind in ('sc_fused', 'struc_fused') and \
                int(opt.train_beam_size or 1) > 1 and \
                opt.train_sample_method in ('greedy', 'beam_search'):
            # the beam's exact early exit reads a flag on the host a step
            return ('train-mode beam sampling (train_beam_size > 1 with a '
                    'greedy train_sample_method)')
        if kind.startswith('struc') and int(getattr(opt, 'use_ppo', 0)) \
                and self.old_captioner is not None \
                and self.old_captioner.device != self.captioner.device:
            return "PPO's old policy on another device"
        if kind == 'struc_fused' and float(
                getattr(opt, 'self_cider_reward_weight', 0)) > 0:
            return ('the self-CIDEr reward: torch.linalg.eigvalsh checks '
                    'its result on the host')
        return ''

    def _baked(self, kind: str):
        """The options a step's graph bakes in (host values read while it
        is captured): a change makes a new cache entry."""
        opt = self.opt
        names = ['label_smoothing', 'drop_worst_rate', 'grad_clip_mode',
                 'grad_clip_value']
        if kind != 'xe':
            names += ['train_sample_method', 'train_beam_size',
                      'train_sample_n', 'cider_reward_weight',
                      'bleu_reward_weight']
        if kind == 'sc_fused':
            names += ['sc_sample_method', 'sc_beam_size']
        if kind.startswith('struc'):
            names += ['structure_loss_weight', 'structure_loss_type',
                      'entropy_reward_weight', 'self_cider_reward_weight',
                      'use_ppo', 'ppo_cliprange', 'ppo_kl_coef',
                      'struc_use_logsoftmax']
        return tuple((n, getattr(opt, n, None)) for n in names)

    def _graphed(self, kind, body, inputs, generators, held=(),
                 flags=()):
        """``body(**inputs)`` as the cached graph of ``kind``; ``held``:
        other objects the graph reads (the scorer); ``flags``: the call's
        switches the body bakes in (drop-worst).  On a CPU trainer with no
        recorder set, the body runs eagerly: CUDA graphs do not exist
        there."""
        why = self.graph_route(kind)
        if why:
            raise ValueError('no graphed %s step: %s; call %s_step'
                             % (kind, why, kind))
        if self.graph_recorder is None and self.captioner.device.type != \
                'cuda':
            return body(**inputs)
        recorder = self.graph_recorder or CudaRecorder
        if recorder is CudaRecorder and any(
                not isinstance(g, torch.Generator) for g in generators):
            raise ValueError('a graphed %s step draws from torch.Generators '
                             'on the captioner\'s device, got %s'
                             % (kind, [type(g).__name__ for g in generators]))
        gens = tuple({id(g): g for g in generators}.values())
        # the generators and the scorer by identity: the key holds them
        # while the graph that reads them lives
        key = (kind, tuple(flags), self._baked(kind), gens, tuple(held)) + \
            tuple((name, None if x is None else (tuple(x.shape), x.dtype))
                  for name, x in inputs.items())
        entry = self._graphs.get(key)
        if entry is None:
            entry = GraphTrainStep(body, inputs, gens,
                                   recorder(self.captioner.device))
            self._graphs[key] = entry
            return entry.first
        return entry(inputs)

    # -- XE -----------------------------------------------------------------
    def xe_step(self, fc, att, labels, masks, am, lr, ss_prob, generator,
                drop_worst_flag=False):
        """One XE step on a batch (labels / masks [B, seq_per_img, L + 2]
        or [N, L + 2]); dropout and scheduled sampling draw from
        ``generator``.  Returns {'loss': the loss before the update, a 0-d
        tensor on the device}."""
        self._scalars(lr, ss_prob)
        return self._xe_body(fc, att, labels, masks, am, generator,
                             drop_worst_flag)

    def xe_step_graphed(self, fc, att, labels, masks, am, lr, ss_prob,
                        generator, drop_worst_flag=False):
        """``xe_step`` as one CUDA graph (the JAX jitted ``xe_step``; one
        capture serves every ``lr`` and ``ss_prob``)."""
        self._scalars(lr, ss_prob)
        return self._graphed(
            'xe', lambda **kw: self._xe_body(generator=generator,
                                             drop_worst_flag=drop_worst_flag,
                                             **kw),
            dict(fc=fc, att=att, labels=labels, masks=masks, am=am),
            (generator,), flags=(drop_worst_flag,))

    def _xe_body(self, fc, att, labels, masks, am, generator,
                 drop_worst_flag):
        logprobs = self.captioner.forward_tf(
            fc, att, labels[..., :-1], am, train=True, ss_prob=self._ss,
            generator=generator)
        loss = self._crit(logprobs, labels[..., 1:], masks[..., 1:],
                          'none' if drop_worst_flag else 'mean')
        if drop_worst_flag:
            loss = self._drop_worst(
                loss, float(getattr(self.opt, 'drop_worst_rate', 0)))
        return self._apply_updates(loss)

    # -- options of the RL passes -------------------------------------------
    def _sc_opt(self):
        """The greedy baseline's decode (loss_wrapper.py:57-62)."""
        return {'sample_method': self.opt.sc_sample_method,
                'beam_size': self.opt.sc_beam_size}

    def _train_opt(self, output_logsoftmax=1):
        """The sampling pass's decode (loss_wrapper.py:64-68)."""
        return {'sample_method': self.opt.train_sample_method,
                'beam_size': self.opt.train_beam_size,
                'sample_n': self.opt.train_sample_n,
                'output_logsoftmax': output_logsoftmax}

    def _reward_weights(self):
        return (float(self.opt.cider_reward_weight),
                float(getattr(self.opt, 'bleu_reward_weight', 0)))

    def _greedy(self, fc, att, am, rng, exit_early=True):
        """The eval-mode baseline: int tokens, copied out of inference
        mode.  Without ``exit_early`` a one-sequence baseline runs all
        ``seq_length`` steps, reading no exit flag on the host."""
        with torch.inference_mode():
            if exit_early or int(self.opt.sc_beam_size or 1) > 1:
                seq, _ = decoding.sample(self.captioner.bind(), fc, att, am,
                                         rng, self._sc_opt(),
                                         return_stats=True)
            else:
                prog = decoding.sample_program(self.captioner.bind(),
                                               self._sc_opt(), rng)
                carry = prog.setup(fc, att, am)
                for t in range(prog.steps):
                    prog.body(carry, t)
                seq = carry['seq']
        return seq.clone()

    def _recompute(self, fc, att, am, gen_seq, generator,
                   output_logsoftmax=1):
        """The sampling pass's tables over ``gen_seq``, with the autograd
        graph, dropout from ``generator``, the BN statistics kept."""
        with self.captioner.bn_frozen():
            return self.captioner.scan_logprobs(
                fc, att, am, gen_seq, generator,
                int(self.opt.train_sample_n), output_logsoftmax)

    def _lm_loss(self, fc, att, labels, masks, am, generator_lm, reduction):
        """The structure steps' XE term (ss_prob 0; BN statistics kept),
        or 0 at structure_loss_weight 1."""
        if float(self.opt.structure_loss_weight) >= 1:
            return torch.zeros((), device=self.captioner.device)
        with self.captioner.bn_frozen():
            logprobs = self.captioner.forward_tf(
                fc, att, labels[..., :-1], am, train=True, ss_prob=0.0,
                generator=generator_lm)
        return self._crit(logprobs, labels[..., 1:], masks[..., 1:],
                          reduction)

    def _old_logprobs(self, fc, att, am, gen_seq):
        """PPO's old policy over ``gen_seq``: eval mode, no graph."""
        return self.old_captioner.scan_logprobs(
            fc, att, am, gen_seq, None, int(self.opt.train_sample_n)).clone()

    def _struc(self, lp, lp_old, gen_seq, scores, self_cider_scores,
               reduction):
        opt = self.opt
        sample_n = int(opt.train_sample_n)
        if int(getattr(opt, 'use_ppo', 0)):
            return losses.ppo_loss(lp, lp_old, gen_seq, scores, sample_n,
                                   cliprange=float(opt.ppo_cliprange),
                                   kl_coef=float(opt.ppo_kl_coef),
                                   reduction=reduction, denom=self._denom)
        return losses.structure_loss(
            lp, gen_seq, scores, opt.structure_loss_type, sample_n,
            entropy_reward_weight=float(
                getattr(opt, 'entropy_reward_weight', 0)),
            self_cider_scores=self_cider_scores,
            self_cider_weight=float(
                getattr(opt, 'self_cider_reward_weight', 0)),
            reduction=reduction, denom=self._denom)

    # -- SCST -----------------------------------------------------------------
    def sc_decode(self, fc, att, am, rng_greedy, rng_sample, generator):
        """The greedy baseline (eval) and ``train_sample_n`` samples a row
        (train mode), neither differentiated: (greedy_seq [B, L], gen_seq
        [B*n, L]).  Dropout is drawn from a copy of ``generator``, which
        ``sc_grad_step`` then draws again."""
        greedy_seq = self._greedy(fc, att, am, rng_greedy)
        gen_seq, _ = self.captioner.sample_train(
            fc, att, am, rng_sample, self._train_opt(), _copy(generator),
            return_stats=True)
        return greedy_seq, gen_seq

    def sc_grad_step(self, fc, att, am, gen_seq, reward, lr, generator,
                     drop_worst_flag=False):
        """The policy gradient over ``sc_decode``'s samples, their tables
        recomputed with the decode's dropout; ``reward`` [B*n, L].
        Returns {'loss'}."""
        self._scalars(lr)
        return self._sc_grad_body(fc, att, am, gen_seq, reward, generator,
                                  drop_worst_flag)

    def sc_grad_step_graphed(self, fc, att, am, gen_seq, reward, lr,
                             generator, drop_worst_flag=False):
        """``sc_grad_step`` as one CUDA graph (the JAX jitted
        ``sc_grad_step``)."""
        self._scalars(lr)
        return self._graphed(
            'sc_grad', lambda **kw: self._sc_grad_body(
                generator=generator, drop_worst_flag=drop_worst_flag, **kw),
            dict(fc=fc, att=att, am=am, gen_seq=gen_seq, reward=reward),
            (generator,), flags=(drop_worst_flag,))

    def _sc_grad_body(self, fc, att, am, gen_seq, reward, generator,
                      drop_worst_flag):
        lp = self._recompute(fc, att, am, gen_seq, generator)
        loss = losses.reward_criterion(
            lp, gen_seq, reward, 'none' if drop_worst_flag else 'mean',
            denom=self._denom)
        if drop_worst_flag:
            loss = self._drop_worst(
                loss, float(getattr(self.opt, 'drop_worst_rate', 0)))
        return self._apply_updates(loss)

    def sc_fused_step(self, fc, att, am, refs, ref_mask, lr, rng_greedy,
                      rng_sample, generator, device_scorer):
        """One SCST iteration on the card: the greedy baseline (all
        ``seq_length`` steps), the sampling pass, the mixed reward
        (cider_reward_weight * CIDEr-D + bleu_reward_weight * BLEU-4 on
        ``device_scorer``; refs [B, R, Lr], ref_mask [B, R]) and the policy
        gradient through the sampling pass's own tables.  Returns {'loss',
        'reward': the mean advantage, 'greedy' [B, L] and 'sampled' [B*n,
        L]: the two passes' tokens}, on the device."""
        self._scalars(lr)
        return self._sc_fused_body(fc, att, am, refs, ref_mask, rng_greedy,
                                   rng_sample, generator, device_scorer)

    def sc_fused_step_graphed(self, fc, att, am, refs, ref_mask, lr,
                              rng_greedy, rng_sample, generator,
                              device_scorer):
        """``sc_fused_step`` as one CUDA graph (the JAX jitted
        ``sc_fused_step``): the baseline, the sampling pass, the reward and
        the update with no host read.  The generators are torch
        Generators on the card; the graph draws from their states."""
        self._scalars(lr)
        return self._graphed(
            'sc_fused', lambda **kw: self._sc_fused_body(
                rng_greedy=rng_greedy, rng_sample=rng_sample,
                generator=generator, device_scorer=device_scorer, **kw),
            dict(fc=fc, att=att, am=am, refs=refs, ref_mask=ref_mask),
            (generator, rng_sample) + (
                () if self.opt.sc_sample_method == 'greedy'
                else (rng_greedy,)),
            held=(device_scorer,))

    def _sc_fused_body(self, fc, att, am, refs, ref_mask, rng_greedy,
                       rng_sample, generator, device_scorer):
        greedy_seq = self._greedy(fc, att, am, rng_greedy, exit_early=False)
        gen_seq, gen_lp = self.captioner.sample_train(
            fc, att, am, rng_sample, self._train_opt(), generator)
        with torch.no_grad():
            reward = device_scorer.self_critical_reward(
                greedy_seq, gen_seq, refs, ref_mask,
                *self._reward_weights())
        loss = losses.reward_criterion(gen_lp, gen_seq, reward,
                                       denom=self._denom)
        out = self._apply_updates(loss, reward=self._mean(reward[:, 0]))
        out.update(greedy=greedy_seq, sampled=gen_seq)
        return out

    # -- structure losses / PPO ----------------------------------------------
    def struc_fused_step(self, fc, att, labels, masks, am, refs, ref_mask,
                         lr, rng, generator, generator_lm, device_scorer):
        """One structure-loss (or PPO) iteration on the card: (1 - w) XE +
        w structure loss over the sampling pass, scored on
        ``device_scorer`` (the self-CIDEr reward too), w =
        structure_loss_weight.  Returns {'loss', 'lm_loss', 'struc_loss',
        'reward' [B, n]} and PPO's terms."""
        self._scalars(lr)
        return self._struc_fused_body(fc, att, labels, masks, am, refs,
                                      ref_mask, rng, generator, generator_lm,
                                      device_scorer)

    def struc_fused_step_graphed(self, fc, att, labels, masks, am, refs,
                                 ref_mask, lr, rng, generator, generator_lm,
                                 device_scorer):
        """``struc_fused_step`` as one CUDA graph (the JAX jitted
        ``struc_fused_step``); the self-CIDEr reward keeps it eager
        (``graph_route``)."""
        self._scalars(lr)
        return self._graphed(
            'struc_fused', lambda **kw: self._struc_fused_body(
                rng=rng, generator=generator, generator_lm=generator_lm,
                device_scorer=device_scorer, **kw),
            dict(fc=fc, att=att, labels=labels, masks=masks, am=am,
                 refs=refs, ref_mask=ref_mask),
            (rng, generator, generator_lm), held=(device_scorer,))

    def _struc_fused_body(self, fc, att, labels, masks, am, refs, ref_mask,
                          rng, generator, generator_lm, device_scorer):
        opt = self.opt
        w = float(opt.structure_loss_weight)
        sample_n = int(opt.train_sample_n)
        lm_loss = self._lm_loss(fc, att, labels, masks, am, generator_lm,
                                'mean')
        gen_seq, gen_lp = self.captioner.sample_train(
            fc, att, am, rng, self._train_opt(self.struc_out_ls), generator)
        self_cider_w = float(getattr(opt, 'self_cider_reward_weight', 0))
        with torch.no_grad():
            scores = device_scorer.score_grouped(
                gen_seq, refs, ref_mask, sample_n,
                *self._reward_weights()).float()
            sc_scores = (device_scorer.self_cider_grouped(gen_seq, sample_n)
                         .float() if self_cider_w > 0 else None)
        lp_old = (self._old_logprobs(fc, att, am, gen_seq)
                  if int(getattr(opt, 'use_ppo', 0)) else None)
        struc = self._struc(gen_lp, lp_old, gen_seq, scores, sc_scores,
                            'mean')
        loss = (1 - w) * lm_loss + w * struc['loss']
        out = self._apply_updates(
            loss, lm_loss=lm_loss.detach(), struc_loss=struc['loss'].detach(),
            **{k: v.detach() for k, v in struc.items()
               if k not in ('loss', 'reward')})
        out['reward'] = struc['reward']
        return out

    def struc_decode(self, fc, att, am, rng, generator):
        """The structure losses' sampling pass (train mode, not
        differentiated): gen_seq [B*n, L].  Dropout is drawn from a copy
        of ``generator``, which ``struc_grad_step`` then draws again."""
        gen_seq, _ = self.captioner.sample_train(
            fc, att, am, rng, self._train_opt(self.struc_out_ls),
            _copy(generator), return_stats=True)
        return gen_seq

    def struc_grad_step(self, fc, att, labels, masks, am, gen_seq, scores,
                        self_cider_scores, lr, generator, generator_lm,
                        drop_worst_flag=False):
        """(1 - w) XE + w structure loss (or PPO) over ``struc_decode``'s
        samples (loss_wrapper.py:26-53), host scores [B*n] and self-CIDEr
        scores [B].  Returns {'loss', 'lm_loss', 'struc_loss', 'reward'}
        and PPO's terms."""
        self._scalars(lr)
        return self._struc_grad_body(fc, att, labels, masks, am, gen_seq,
                                     scores, self_cider_scores, generator,
                                     generator_lm, drop_worst_flag)

    def struc_grad_step_graphed(self, fc, att, labels, masks, am, gen_seq,
                                scores, self_cider_scores, lr, generator,
                                generator_lm, drop_worst_flag=False):
        """``struc_grad_step`` as one CUDA graph (the JAX jitted
        ``struc_grad_step``)."""
        self._scalars(lr)
        return self._graphed(
            'struc_grad', lambda **kw: self._struc_grad_body(
                generator=generator, generator_lm=generator_lm,
                drop_worst_flag=drop_worst_flag, **kw),
            dict(fc=fc, att=att, labels=labels, masks=masks, am=am,
                 gen_seq=gen_seq, scores=scores,
                 self_cider_scores=self_cider_scores),
            (generator, generator_lm), flags=(drop_worst_flag,))

    def _struc_grad_body(self, fc, att, labels, masks, am, gen_seq, scores,
                         self_cider_scores, generator, generator_lm,
                         drop_worst_flag):
        opt = self.opt
        w = float(opt.structure_loss_weight)
        reduction = 'none' if drop_worst_flag else 'mean'
        out = {}
        lm_loss = self._lm_loss(fc, att, labels, masks, am, generator_lm,
                                reduction)
        if w > 0:
            lp = self._recompute(fc, att, am, gen_seq, generator,
                                 self.struc_out_ls)
            lp_old = (self._old_logprobs(fc, att, am, gen_seq)
                      if int(getattr(opt, 'use_ppo', 0)) else None)
            struc = self._struc(lp, lp_old, gen_seq, scores,
                                self_cider_scores, reduction)
            struc_loss = struc['loss']
            out.update({k: v.detach() for k, v in struc.items()
                        if k != 'loss'})
            reward = out.pop('reward')
        else:
            # structure_loss_weight 0 (pure XE through the structure path)
            # still reports the scores as its reward
            struc_loss = torch.zeros((), device=self.captioner.device)
            reward = scores.reshape(-1, int(opt.train_sample_n))
        # the reported terms: this rank's shares of the global means
        shares = {k: self._mean(x.detach()) if x.dim() else x.detach()
                  for k, x in (('lm_loss', lm_loss),
                               ('struc_loss', struc_loss))}
        if drop_worst_flag and not struc_loss.dim():
            # a structure loss that is one mean (margin, risk) enters every
            # row as the global batch's mean, its gradient shared by the
            # ranks
            struc_loss = mesh.all_reduce_grad(struc_loss,
                                              self.mesh.data_group)
        loss = (1 - w) * lm_loss + w * struc_loss
        if drop_worst_flag:
            loss = self._drop_worst(
                loss, float(getattr(opt, 'drop_worst_rate', 0)))
        out = self._apply_updates(loss, **shares, **out)
        out['reward'] = reward
        return out
