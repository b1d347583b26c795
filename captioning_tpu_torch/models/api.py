"""Captioner: a ported model bound into the decode engine's protocol.

Port of ``captioning_tpu/models/api.py``: ``setup`` builds the
transformer, the BERT captioner (``models/bert_cap.py``), the
Meshed-Memory Transformer (``models/m2.py``), AoANet (``models/aoa.py``)
or one of the RNN captioners of ``harness.MODELS``: every
``caption_model`` key of the JAX package.  ``bind`` returns the
``DecodeModel`` the engine drives, ``sample_beam`` /
``sample_stats`` / ``sample`` / ``forward_tf`` are the eager entry points
(the decodes and their graph counterparts in ``DecodeEntries``, which
``models.ensemble.EnsembleCaptioner`` shares),
``sample_beam_graphed`` / ``sample_stats_graphed`` their CUDA-graph
counterparts (the JAX ``sample_beam_jit`` / ``sample_stats_jit``, with
``_graph_cache`` for ``_jit_cache``), which ``eval_split`` calls where the
route allows; ``forward_tf(train=True)`` is the teacher-forced pass the XE
trainer differentiates (``modules.trainer``), ``sample_train`` the
train-mode sampling of the RL steps and ``scan_logprobs`` the recompute
over a sampled sequence.
Parameters live in ``self.module`` on ``self.device``; ``shard_vocab``
cuts its vocab tensors to this rank's shards of a model axis
(``parallel/shard.py``), after which the transformer's decode runs B2 in
shard mode (``logit_topk_sharded``) and ``jax_variables`` gathers the full
arrays.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from ..engine import decoding
from ..engine.decoding import DecodeModel
from ..engine.graphs import CudaRecorder, GraphDecode
from ..ops.logit_topk import logit_topk, logit_topk_sharded
from ..parallel import mesh, shard
from ..utils import tracing
from . import harness
from .aoa import AoACaptioner
from .bert_cap import BertCaptioner
from .config import ModelConfig, config_from_opt
from .harness import AttCaptioner
from .layers import MaskedBatchNorm, compute_param, sync_compute_copies
from .m2 import M2Captioner
from .transformer import TransformerCaptioner

# the module of each key but the RNN captioners' (harness.AttCaptioner)
_MODULES = {'transformer': TransformerCaptioner, 'bert': BertCaptioner,
            'm2transformer': M2Captioner, 'aoa': AoACaptioner}


def _vocab_indices(vocab: Optional[Dict[str, str]], vocab_size: int):
    """The bad-ending ids (the words of ``harness.BAD_ENDINGS``, which
    ``remove_bad_endings`` bans before EOS) and the UNK id
    (``vocab[str(vocab_size)] == 'UNK'`` in the COCO vocab)."""
    if vocab is None:
        return (), None
    bad_ix = tuple(int(k) for k, v in vocab.items()
                   if v in harness.BAD_ENDINGS)
    unk_idx = vocab_size if vocab.get(str(vocab_size)) == 'UNK' else None
    return bad_ix, unk_idx


def freeze_opt(opt: Dict[str, Any]):
    """Hashable cache key from a decode-options dict (the JAX package's
    ``freeze_opt``): dict / list values are left out."""
    return tuple(sorted((k, v) for k, v in opt.items()
                        if not isinstance(v, (dict, list))))


def _is_cache(name: str) -> bool:
    return name[:1] in ('k', 'v') and name[1:].isdigit()


class DecodeEntries:
    """The eval decode entry points over ``self.bind()``, shared by
    ``Captioner`` and ``models.ensemble.EnsembleCaptioner``: the eager
    ``sample_beam`` / ``sample`` / ``sample_stats`` and their CUDA-graph
    counterparts ``sample_beam_graphed`` / ``sample_stats_graphed`` with
    ``graph_route`` and ``graph_launches``.  A subclass sets ``device``,
    ``_graph_cache`` (a dict) and ``graph_recorder``, and gives ``bind``
    and ``_graph_dtype`` (the compute dtype part of a graph's cache
    key)."""

    @torch.inference_mode()
    def sample_beam(self, fc_feats, att_feats, att_masks, rng,
                    opt: Dict[str, Any], want_logps: bool = False):
        """(seq, {'ent_sum', 'lp_sum'} or with ``want_logps`` the winners'
        replayed distributions [N, L, V+1], done) — see
        decoding.sample_beam."""
        return decoding.sample_beam(self.bind(), fc_feats, att_feats,
                                    att_masks, rng, opt, want_logps)

    @torch.inference_mode()
    def sample(self, fc_feats, att_feats, att_masks, rng,
               opt: Dict[str, Any]):
        """(seq, the per-step distributions [N, L, V+1]; [N, L] sampled
        logprobs for diverse groups) — see decoding.sample.  ``rng``: a
        ``torch.Generator`` on ``self.device`` for the sampling draws (or
        a ``draw`` callable, or None for seed 0)."""
        return decoding.sample(self.bind(), fc_feats, att_feats, att_masks,
                               rng, opt, return_stats=False)

    @torch.inference_mode()
    def sample_stats(self, fc_feats, att_feats, att_masks, rng,
                     opt: Dict[str, Any]):
        """(seq, {'ent_sum', 'lp_sum'}) for the sample family (greedy,
        sample, gumbel, top-k, top-p): the sums carried, with the exact
        early exit.  ``rng`` as in ``sample``."""
        return decoding.sample(self.bind(), fc_feats, att_feats, att_masks,
                               rng, opt, return_stats=True)

    # -- graph decodes ----------------------------------------------------------
    def graph_route(self, kind: str, opt: Dict[str, Any]) -> str:
        """'' when ``kind`` ('beam' or 'stats') with ``opt`` takes a graph
        decode, else what keeps it on the eager entry (``sample_beam`` /
        ``sample_stats``).  The graphs take the single-group beam
        (``decoding.beam_program``) without the replay, and greedy stats
        without the step constraints (``decoding.sample_program``)."""
        if getattr(self, 'vocab_shards', None):
            return 'model axis (model > 1): per-step collectives'
        if kind == 'beam':
            if not decoding.beam_fast(opt):
                return ('the general beam body (diverse groups, '
                        'decoding_constraint, remove_bad_endings)')
            bdash = int(opt.get('beam_size', 10) or 10)
            if int(opt.get('sample_n', 1) or 1) not in (1, bdash):
                return 'sample_n other than 1 or the beam size'
            return ''
        method = opt.get('sample_method', 'greedy') or 'greedy'
        if (int(opt.get('beam_size', 1) or 1) > 1
                and method in ('greedy', 'beam_search')):
            return 'beam search (sample_beam_graphed)'
        if int(opt.get('group_size', 1) or 1) > 1:
            return 'diverse sampling groups'
        if method != 'greedy':
            return 'the sampling method %r, which draws noise' % method
        if any(int(opt.get(k, 0) or 0) for k in (
                'decoding_constraint', 'block_trigrams',
                'remove_bad_endings')):
            return 'the step constraints'
        return ''

    @torch.inference_mode()
    def sample_beam_graphed(self, fc_feats, att_feats, att_masks, rng,
                            opt: Dict[str, Any]):
        """The counterpart of the JAX ``sample_beam_jit(...,
        want_logps=False)``: (seq, {'ent_sum', 'lp_sum'}, done) as
        ``sample_beam`` gives them, from a CUDA-graph decode
        (``engine.graphs``) cached in ``_graph_cache`` by the options, B,
        the feature shapes and dtypes, the compute dtype
        (``_graph_dtype``) and want_logps False.  Temperature,
        ``suppress_UNK`` and the length penalty are in the key: they are
        host arguments of B2 and of the penalty, baked into the graphs (the
        JAX key leaves them out as traced operands).
        The outputs are fresh tensors.  Options the graphs do not take
        (``graph_route``) raise: ``sample_beam`` decodes them.  On a CPU
        captioner the same program runs eagerly: CUDA graphs do not exist
        there.  ``rng`` is unused, as in beam decoding."""
        return self._graphed('beam', decoding.beam_program, fc_feats,
                             att_feats, att_masks, opt)

    @torch.inference_mode()
    def sample_stats_graphed(self, fc_feats, att_feats, att_masks, rng,
                             opt: Dict[str, Any]):
        """The counterpart of the JAX ``sample_stats_jit`` on its greedy
        route: (seq, {'ent_sum', 'lp_sum'}) as ``sample_stats`` gives them,
        from a cached CUDA-graph decode, as ``sample_beam_graphed``.  The
        sampling methods, diverse groups and the step constraints raise
        (``graph_route``): ``sample_stats`` decodes them.  Greedy draws
        nothing: ``rng`` is unused."""
        return self._graphed('stats', decoding.sample_program, fc_feats,
                             att_feats, att_masks, opt)

    def _graphed(self, kind, make, fc, att, am, opt):
        why = self.graph_route(kind, opt)
        if why:
            raise ValueError('no graph decode for %s: call %s' % (
                why, {'beam': 'sample_beam', 'stats': 'sample_stats'}[kind]))
        if self.graph_recorder is None and self.device.type != 'cuda':
            prog = make(self.bind(), opt)
            return prog.result(decoding.run_eager(prog, fc, att, am))
        key = (kind, freeze_opt(opt), self._graph_dtype(), False) + tuple(
            None if x is None else (tuple(x.shape), x.dtype)
            for x in (fc, att, am))
        entry = self._graph_cache.get(key)
        if entry is None:
            recorder = (self.graph_recorder or CudaRecorder)(self.device)
            entry = GraphDecode(make(self.bind(), opt), fc, att, am,
                                recorder)
            self._graph_cache[key] = entry
        return entry(fc, att, am)

    def graph_launches(self) -> Dict[str, int]:
        """Kernel wrapper name -> the launches that the replays of every
        cached graph decode ran."""
        out: Dict[str, int] = {}
        for entry in self._graph_cache.values():
            for name, n in entry.launches().items():
                out[name] = out.get(name, 0) + n
        return out


class Captioner(DecodeEntries):
    """A model module + static decode metadata, on one device: the GPU
    unless ``device='cpu'`` is asked for (the plain twins of the kernels).
    Without a CUDA device, ``device='cuda'`` raises."""

    def __init__(self, cfg: ModelConfig, vocab: Optional[Dict[str, str]] = None,
                 device='cuda'):
        if (torch.device(device).type == 'cuda'
                and not torch.cuda.is_available()):
            raise RuntimeError("device 'cuda': no CUDA device is available "
                               "(pass device='cpu' to run the plain twins)")
        if cfg.caption_model in _MODULES:
            self.module_cls = _MODULES[cfg.caption_model]
        elif cfg.caption_model in harness.MODELS:
            self.module_cls = AttCaptioner
        else:
            raise ValueError('caption model not supported: %r'
                             % cfg.caption_model)
        self.cfg = cfg
        self.vocab = vocab
        self.bad_endings_ix, self.unk_idx = _vocab_indices(vocab,
                                                           cfg.vocab_size)
        if self.unk_idx is None:
            self.unk_idx = cfg.unk_idx
        self.device = torch.device(device)
        self.module = None    # set by init_params / load_params
        # parameter name -> parallel.vocab.VocabShard (shard_vocab)
        self.vocab_shards = {}
        # (float32 master, compute-dtype copy) pairs; none in float32
        self._compute_pairs = []
        # (kind, options, shapes, dtypes) -> GraphDecode
        self._graph_cache = {}
        # the graph decodes' recorder class: None is CudaRecorder on a CUDA
        # captioner, the eager program on a CPU one (tests set
        # engine.graphs.EagerRecorder here to run the cache's plumbing)
        self.graph_recorder = None

    # -- params ------------------------------------------------------------
    def init_params(self, generator: torch.Generator):
        """Random weights with the JAX package's init, drawn on the CPU from
        ``generator`` and moved to the device (float32 masters and their
        compute-dtype copies)."""
        module = self.module_cls(self.cfg).init_weights(generator)
        return self._install(module.state_dict())

    def load_params(self, npz_path: str):
        """Weights from a JAX ``model.npz`` checkpoint."""
        from ..utils.misc import load_pytree
        from ..utils.weights import state_dict_from_jax
        return self._install(state_dict_from_jax(load_pytree(npz_path),
                                                 self.cfg))

    def load_jax_variables(self, variables):
        """Weights from a JAX param tree held as numpy arrays."""
        from ..utils.weights import state_dict_from_jax
        return self._install(state_dict_from_jax(variables, self.cfg))

    def _install(self, state_dict):
        with tracing.span('model.install'):
            module = self.module_cls(self.cfg)
            module.load_state_dict(state_dict, strict=True)
            # frozen until trainable(): decoding needs no autograd graph.
            # The parameters stay float32 (the masters); at a bf16 compute
            # dtype the module computes with copies in that dtype
            # (layers.compute_param)
            self.module = module.requires_grad_(False).to(self.device).eval()
            self._compute_pairs = self.module.install_compute_copies()
        self._graph_cache = {}     # its graphs read the old module
        self.vocab_shards = {}
        return self

    def shard_vocab(self, grid=None):
        """Cut the vocab tensors (``logit``, ``generator``, ``tgt_embed``)
        to this rank's shards of the model axis of ``grid`` (default the
        current mesh), by the JAX ``param_sharding_spec``; the
        compute-dtype copies follow.  Nothing at model 1."""
        self.vocab_shards = shard.shard_module(self.module,
                                               grid or mesh.current())
        if self.vocab_shards:
            self._compute_pairs = self.module.install_compute_copies()
            self._graph_cache = {}
        return self

    def full_state(self, state):
        """``state`` (by parameter name) with the shards gathered into full
        arrays over the model group; every rank of the group calls it."""
        return shard.gather_state(state, self.vocab_shards)

    def local_state(self, state):
        """Full arrays by parameter name cut to this rank's shards."""
        return shard.local_state(state, self.vocab_shards)

    def replicate(self):
        """Rank 0's parameters and BatchNorm statistics on every rank of
        the data axis, and the compute-dtype copies rewritten from them
        (the JAX package's ``globalize_replicated``): after an init or a
        load, so that the ranks start equal.  One rank: nothing."""
        if self.vocab_shards:
            raise ValueError('replicate() before shard_vocab(): the ranks '
                             'of a model group hold different shards')
        mesh.broadcast_module(self.module)
        self.sync_compute_weights()
        return self

    def sync_compute_weights(self):
        """Rewrite the compute-dtype copies from the float32 masters, in
        place (the trainer calls it after each optimizer step, inside a
        graphed step's capture too): a graph decode captured earlier reads
        the same addresses, so it decodes with the updated weights.  A
        float32 captioner has no copies."""
        sync_compute_copies(self._compute_pairs)

    def trainable(self):
        """Make the float32 master parameters require grad, for
        ``modules.trainer``: their gradients and the optimizer's state are
        float32 at any compute dtype; a bf16 captioner computes with its
        bf16 copies, whose uses cast their gradients back to float32
        (``layers.CastUse``)."""
        self.module.requires_grad_(True)
        return self

    def jax_variables(self):
        """The JAX variables tree (``params``, with use_bn ``batch_stats``)
        as float32 numpy arrays, the masters at any compute dtype: what
        ``misc.save_pytree`` writes as a ``model.npz`` that the JAX package
        loads."""
        from ..utils.misc import _unflatten_tree
        from ..utils.weights import jax_from_state_dict
        return _unflatten_tree(jax_from_state_dict(
            self.full_state(self.module.state_dict()), self.cfg))

    # -- engine protocol -------------------------------------------------------
    def bind(self) -> DecodeModel:
        module = self.module
        cfg = self.cfg

        # the rng of prepare / step is the train switch: a generator draws
        # dropout from it (and updates the BatchNorms' running statistics),
        # None is eval
        def prepare(fc, att, att_masks, rng):
            return module.prepare_feature(fc, att, att_masks, rng)

        def init_state(batch, beam=False):
            return module.init_state(batch, beam=beam)

        def step(it, feats, state, rng, logsoftmax=True, uniform_t=False,
                 beam_width=0):
            return module.step(it, feats, state, logsoftmax, uniform_t,
                               beam_width, gen=rng)

        common = dict(
            prepare=prepare, init_state=init_state, step=step,
            seq_length=cfg.seq_length, vocab_plus=cfg.vocab_size + 1,
            bos_idx=cfg.bos_idx, eos_idx=cfg.eos_idx, pad_idx=cfg.pad_idx,
            unk_idx=self.unk_idx, bad_endings_ix=self.bad_endings_ix)
        if issubclass(self.module_cls, AttCaptioner):
            # the attention of the shared-feats models (AoA's too) reads one
            # feats row per beam block, the other RNN models get one per
            # lane; the
            # state is reordered by a plain row gather (no ancestry) and
            # the vocab epilogue is the engine's plain-step route
            return DecodeModel(shared_beam_feats=module.shared_feats,
                               **common)

        def step_topk(it, feats, state, rng, k, temp, unk_bias, unk_idx,
                      beam_width=0):
            # the rng is the train switch, as in ``step``: a train-mode beam
            # draws its dropout from it; the hidden B2 reads has none
            hid, st = module.step(it, feats, state, uniform_t=True,
                                  beam_width=beam_width, return_hidden=True,
                                  gen=rng)
            # B2 picks its path by the weight's dtype: the compute copy
            gen = module.generator
            w, b = compute_param(gen, 'weight'), compute_param(gen, 'bias')
            if getattr(gen, 'vocab_parallel', False):
                # a model axis's shard: the parts, all-gathered, merged
                sh = gen.shard
                tv, ti, rs, en = logit_topk_sharded(
                    hid, w, b[sh.offset:sh.offset + sh.rows], sh.group, temp,
                    unk_bias, k=int(k), unk_idx=int(unk_idx), v_off=sh.offset,
                    V1=sh.V1)
            else:
                tv, ti, rs, en = logit_topk(hid, w, b, temp, unk_bias,
                                            k=int(k), unk_idx=int(unk_idx))
            return tv, ti, rs, en, st

        def beam_init(state, bdash):
            # every past position initially lives in the row's own slot
            # (the bos entry was replicated to all lanes)
            n = state['k0'].shape[0]
            T = state['k0'].shape[1]
            lanes = torch.arange(n, dtype=torch.int32,
                                 device=state['k0'].device) % bdash
            return dict(state, anc=lanes[:, None].expand(n, T).contiguous())

        def beam_reorder(state, flat_idx):
            # physical K/V slots never move; rows inherit the parent's
            # ancestry by gather (the step t is a host int)
            return {kk: (vv if _is_cache(kk) or not torch.is_tensor(vv)
                         else vv.index_select(0, flat_idx))
                    for kk, vv in state.items()}

        return DecodeModel(beam_init=beam_init, beam_reorder=beam_reorder,
                           shared_beam_feats=True, step_topk=step_topk,
                           **common)

    def _graph_dtype(self):
        return self.cfg.dtype

    # -- entry points ------------------------------------------------------------
    def forward_tf(self, fc_feats, att_feats, seq, att_masks,
                   train: bool = False, ss_prob: float = 0.0,
                   generator: Optional[torch.Generator] = None):
        """Teacher-forced logprobs [N, T, V+1] over input tokens ``seq``
        [N, T] or [B, seq_per_img, T].  Eval runs under inference mode.
        ``train`` builds the autograd graph, draws dropout and scheduled
        sampling from ``generator`` (on ``self.device``; seed 0 when None,
        as the JAX package takes PRNGKey(0)) and folds the batch's
        statistics into the BatchNorms' running ones, in place.  The
        generator is the train switch (the modules never read their
        ``training`` flag), so an eval entry point between train steps
        reads the parameters and buffers and writes nothing."""
        if not train:
            with torch.inference_mode():
                return self.module.forward_tf(fc_feats, att_feats, seq,
                                              att_masks)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        with torch.enable_grad():
            return self.module.forward_tf(fc_feats, att_feats, seq,
                                          att_masks, generator, ss_prob)

    def sample_train(self, fc_feats, att_feats, att_masks, rng,
                     opt: Dict[str, Any], generator: torch.Generator,
                     return_stats: bool = False):
        """The train-mode ``sample``: dropout drawn from ``generator`` (on
        ``self.device``), the BatchNorms' batch statistics folded into
        their running ones once, by prepare.  ``rng`` draws the sampling
        noise, as in ``sample``.  Without ``return_stats`` the per-step
        tables [N, L, V+1] carry the autograd graph (the fused RL steps
        differentiate them; a beam's are its winners' replayed tables,
        diverse groups give [N, L] sampled logprobs); with it nothing is
        recorded and the sampling stops once every row has finished (a
        beam gives its carried sums).  Beam options (``train_beam_size >
        1``) decode on the eval beam's route, the kernels fed the dropped
        inputs (``decoding.sample_beam``)."""
        dm = self.bind()
        with (torch.no_grad() if return_stats else torch.enable_grad()):
            return decoding.sample(dm, fc_feats, att_feats, att_masks, rng,
                                   opt, return_stats=return_stats,
                                   generator=generator)

    @contextlib.contextmanager
    def bn_frozen(self):
        """Train-mode passes inside leave the BatchNorms' running
        statistics as they were on entry: an RL step updates them once,
        from its sampling pass's prepare, and its recomputes and XE term
        leave them alone."""
        saved = [(b, b.clone()) for m in self.module.modules()
                 if isinstance(m, MaskedBatchNorm) for b in m.buffers()]
        try:
            yield
        finally:
            with torch.no_grad():
                for b, v in saved:
                    b.copy_(v)

    def scan_logprobs(self, fc_feats, att_feats, att_masks, gen_seq,
                      generator: Optional[torch.Generator] = None,
                      sample_n: int = 1, output_logsoftmax: int = 1):
        """The per-step distributions [N, L, V+1] of ``gen_seq`` [N, L]
        recomputed (decoding.scan_logprobs; logits with
        ``output_logsoftmax=0``).  The generator is the train switch, as
        in ``forward_tf``: None runs under inference mode; a generator (on
        ``self.device``) builds the autograd graph with dropout drawn from
        it."""
        dm = self.bind()
        if generator is None:
            with torch.inference_mode():
                return decoding.scan_logprobs(dm, fc_feats, att_feats,
                                              att_masks, gen_seq, None,
                                              sample_n, output_logsoftmax)
        with torch.enable_grad():
            # a sequence sampled under inference mode is copied into a
            # tensor that autograd may save
            return decoding.scan_logprobs(dm, fc_feats, att_feats, att_masks,
                                          gen_seq.clone(), generator,
                                          sample_n, output_logsoftmax)


def setup(opt, vocab: Optional[Dict[str, str]] = None,
          device='cuda') -> Captioner:
    """Model factory: the transformer, bert, m2transformer, AoANet and
    the RNN captioners of ``harness.MODELS``."""
    return Captioner(config_from_opt(opt, opt.vocab_size), vocab, device)
