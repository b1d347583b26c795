"""Captioner: a ported model bound into the decode engine's protocol.

Port of ``captioning_tpu/models/api.py``: ``setup`` builds the
transformer or one of the RNN captioners of ``harness.MODELS`` (other
model keys raise), ``bind`` returns the ``DecodeModel`` the engine drives,
``sample_beam``/``sample_stats``/``forward_tf`` are the entry points
``eval_split`` calls, and ``forward_tf(train=True)`` is the teacher-forced
pass the XE trainer differentiates (``modules.trainer``).  Parameters live
in ``self.module`` on ``self.device``; there is no jit cache, PyTorch runs
eagerly.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..engine import decoding
from ..engine.decoding import DecodeModel
from ..ops.logit_topk import logit_topk
from . import harness
from .config import ModelConfig, config_from_opt
from .harness import AttCaptioner
from .transformer import TransformerCaptioner


def _unk_index(vocab: Optional[Dict[str, str]], vocab_size: int):
    """The UNK id: ``vocab[str(vocab_size)] == 'UNK'`` in the COCO vocab."""
    if vocab is not None and vocab.get(str(vocab_size)) == 'UNK':
        return vocab_size
    return None


def _is_cache(name: str) -> bool:
    return name[:1] in ('k', 'v') and name[1:].isdigit()


class Captioner:
    """A model module + static decode metadata, on one device: the GPU
    unless ``device='cpu'`` is asked for (the plain twins of the kernels).
    Without a CUDA device, ``device='cuda'`` raises."""

    def __init__(self, cfg: ModelConfig, vocab: Optional[Dict[str, str]] = None,
                 device='cuda'):
        if (torch.device(device).type == 'cuda'
                and not torch.cuda.is_available()):
            raise RuntimeError("device 'cuda': no CUDA device is available "
                               "(pass device='cpu' to run the plain twins)")
        if cfg.caption_model == 'transformer':
            self.module_cls = TransformerCaptioner
        elif cfg.caption_model in harness.MODELS:
            self.module_cls = AttCaptioner
        else:
            raise NotImplementedError(
                'caption model %r is not ported yet (transformer, %s are); '
                'see ROADMAP.md' % (cfg.caption_model,
                                    ', '.join(harness.MODELS)))
        self.cfg = cfg
        self.unk_idx = _unk_index(vocab, cfg.vocab_size)
        if self.unk_idx is None:
            self.unk_idx = cfg.unk_idx
        self.device = torch.device(device)
        self.module = None    # set by init_params / load_params

    # -- params ------------------------------------------------------------
    def init_params(self, generator: torch.Generator):
        """Random weights with the JAX package's init, drawn on the CPU from
        ``generator`` and moved to the device in the compute dtype."""
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
        module = self.module_cls(self.cfg)
        module.load_state_dict(state_dict, strict=True)
        # frozen until trainable(): decoding needs no autograd graph
        self.module = (module.requires_grad_(False).to(self.device)
                       .to_compute_dtype().eval())
        return self

    def trainable(self):
        """Make the parameters require grad, for ``modules.trainer``.  They
        stay float32: training in bf16 needs float32 master weights, which
        are not ported (ROADMAP.md)."""
        if self.cfg.dtype != torch.float32:
            raise NotImplementedError(
                'training in %s needs float32 master weights, not ported '
                'yet; see ROADMAP.md (train with --compute_dtype float32)'
                % self.cfg.dtype)
        self.module.requires_grad_(True)
        return self

    def jax_variables(self):
        """The JAX variables tree (``params``, with use_bn ``batch_stats``)
        as float32 numpy arrays: what ``misc.save_pytree`` writes as a
        ``model.npz`` that the JAX package loads."""
        from ..utils.misc import _unflatten_tree
        from ..utils.weights import jax_from_state_dict
        return _unflatten_tree(jax_from_state_dict(self.module.state_dict(),
                                                   self.cfg))

    # -- engine protocol -------------------------------------------------------
    def bind(self) -> DecodeModel:
        module = self.module
        cfg = self.cfg

        def prepare(fc, att, att_masks, rng):
            return module.prepare_feature(fc, att, att_masks)

        def init_state(batch, beam=False):
            return module.init_state(batch)

        def step(it, feats, state, rng, logsoftmax=True, uniform_t=False,
                 beam_width=0):
            # eval steps draw no randomness: the rng is accepted and unused
            return module.step(it, feats, state, logsoftmax, uniform_t,
                               beam_width)

        common = dict(
            prepare=prepare, init_state=init_state, step=step,
            seq_length=cfg.seq_length, vocab_plus=cfg.vocab_size + 1,
            bos_idx=cfg.bos_idx, eos_idx=cfg.eos_idx, pad_idx=cfg.pad_idx,
            unk_idx=self.unk_idx)
        if self.module_cls is AttCaptioner:
            # the attention heads of the shared-feats models read one feats
            # row per beam block, the other RNN models get one per lane; the
            # state is reordered by a plain row gather (no ancestry) and
            # the vocab epilogue is the engine's plain-step route
            return DecodeModel(shared_beam_feats=module.shared_feats,
                               **common)

        def step_topk(it, feats, state, rng, k, temp, unk_bias, unk_idx,
                      beam_width=0):
            # eval steps draw no randomness: the rng is accepted and unused
            hid, st = module.step(it, feats, state, uniform_t=True,
                                  beam_width=beam_width, return_hidden=True)
            tv, ti, rs, en = logit_topk(
                hid, module.generator.weight, module.generator.bias, temp,
                unk_bias, k=int(k), unk_idx=int(unk_idx))
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

    @torch.inference_mode()
    def sample_beam(self, fc_feats, att_feats, att_masks, rng,
                    opt: Dict[str, Any], want_logps: bool = False):
        """(seq, {'ent_sum', 'lp_sum'}, done) — see decoding.sample_beam."""
        return decoding.sample_beam(self.bind(), fc_feats, att_feats,
                                    att_masks, rng, opt, want_logps)

    @torch.inference_mode()
    def sample_stats(self, fc_feats, att_feats, att_masks, rng,
                     opt: Dict[str, Any]):
        """(seq, {'ent_sum', 'lp_sum'}) for greedy decode."""
        return decoding.sample(self.bind(), fc_feats, att_feats, att_masks,
                               rng, opt, return_stats=True)


def setup(opt, vocab: Optional[Dict[str, str]] = None,
          device='cuda') -> Captioner:
    """Model factory: the transformer and the RNN captioners of
    ``harness.MODELS``, for now."""
    return Captioner(config_from_opt(opt, opt.vocab_size), vocab, device)
