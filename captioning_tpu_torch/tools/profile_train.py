"""Profile train steps of a full-width captioner on the GPU with
``torch.profiler``: the step's wall, device busy, idle share and the
kernels that take the device time.

    python -m captioning_tpu_torch.tools.profile_train \\
        [--model updown|stackatt|transformer|bert|m2transformer|aoa|att2in|
                 show_tell]
        [--mode xe|scst|scst_grad|struc] [--route eager|graph]
        [--compute_dtype float32|bfloat16]

The model is built at the flagship widths of ``profile_decode.MODELS`` in
float32 (``--compute_dtype bfloat16``: computing in bf16 with float32
master weights) from the port's seeded init, and trained with its config's
options (``TRAIN``: UpDown of ``configs/updown/updown.yml`` and StackAtt
at adam 5e-4, the scheduled-sampling ramp's maximum 0.25 and the
``opts.py`` dropout 0.5; the transformer of
``configs/transformer/transformer.yml`` with noam, warmup 20000, dropout
0.1, and bert and m2transformer at its widths and options; clip by value
0.1) on one seeded batch of 10 images x 5 captions of
label length 16, as ``chip_smoke.py`` phase 9 trains them; AoANet of
``configs/aoa.yml`` at adam 2e-4 with label smoothing 0.2, att2in and
ShowTell as UpDown.  ``--mode scst`` takes the fused SCST step instead (``Trainer.sc_fused_step``), and
``--mode struc`` the fused structure step (``struc_fused_step``,
new_self_critical), with the SCST stages' options (``RL``: UpDown of
``configs/updown/updown_sc.yml`` and the transformer of
``configs/transformer/transformer_sc.yml`` (bert and m2transformer too)
and AoANet of ``configs/aoa_sc.yml``, adam at their rates,
``train_sample_n`` 5 sampled against a greedy baseline, max length 20):
their rewards against 5 references of label length 16 an image, scored on
the card with a df table built as ``scripts/prepro_ngrams.py`` builds it
over a seeded random corpus of 5000 images x 5 references (``corpus_df``),
as ``chip_smoke.py`` phase 11 times them; ``--mode scst_grad`` the
host-scorer route's gradient half (``sc_grad_step``) over one
``sc_decode`` of the batch, its reward from the card's scorer.  ``--route
graph`` runs the steps as CUDA graphs (``Trainer.*_step_graphed``; the
first warm-up step captures), as ``chip_smoke.py`` phase 13 times them.
3 warm-up
steps, 5 unprofiled steps (host clock ending in a synchronize), then 3
profiled steps.  Device busy is the sum of the self device time of the
profiler's device events, user annotations (the optimizer's step range)
left out since they span kernels counted already; idle share = 1 - busy /
the profiled steps' wall.  Prints JSON.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import torch

from . import profile_decode as pd
from ..utils.optimizers import noam_rate

L = 16                          # COCO's label length
WARM, WALLS, PROFILED, TOP = 3, 5, 3, 15
# per model: the captioner's option overrides, the trainer's, ss_prob and
# the learning rate at iteration it (1-based)
TRAIN = {
    'updown': ({'drop_prob_lm': 0.5}, {}, 0.25, lambda it: 5e-4),
    'stackatt': ({'drop_prob_lm': 0.5}, {}, 0.25, lambda it: 5e-4),
    'att2in': ({'drop_prob_lm': 0.5}, {}, 0.25, lambda it: 5e-4),
    'show_tell': ({'drop_prob_lm': 0.5}, {}, 0.25, lambda it: 5e-4),
    # configs/aoa.yml: adam 2e-4, label smoothing 0.2
    'aoa': ({'drop_prob_lm': 0.5}, {'learning_rate': 2e-4,
                                    'label_smoothing': 0.2}, 0.25,
            lambda it: 2e-4),
    # drop_prob_lm (the att embed's) keeps its opts.py 0.5
    'transformer': ({'drop_prob_lm': 0.5, 'dropout': 0.1},
                    {'noamopt': True, 'noamopt_warmup': 20000}, 0.0,
                    lambda it: noam_rate(it, 512, 1.0, 20000)),
}
# bert and m2transformer have no config: the transformer's
TRAIN['bert'] = TRAIN['m2transformer'] = TRAIN['transformer']


# per model: the captioner's option overrides and the trainer's, of the
# SCST stage (configs/updown/updown_sc.yml, configs/transformer/
# transformer_sc.yml, configs/aoa_sc.yml: adam, no noam)
RL = {
    'updown': ({'drop_prob_lm': 0.5}, {'learning_rate': 5e-5}),
    'aoa': ({'drop_prob_lm': 0.5}, {'learning_rate': 2e-5}),
    'transformer': ({'drop_prob_lm': 0.5, 'dropout': 0.1},
                    {'learning_rate': 1e-5}),
}
RL['bert'] = RL['m2transformer'] = RL['transformer']
CORPUS_IMAGES, CORPUS_REFS = 5000, 5


def train_captioner(model: str, device: str, dtype: str = 'float32', **kw):
    """A ``Captioner`` at the flagship widths computing in ``dtype``
    (float32 masters at either), with ``kw`` overriding its options, from
    the port's init with a seeded generator."""
    from ..models.api import setup
    opt = SimpleNamespace(caption_model=model, vocab_size=pd.V,
                          fc_feat_size=pd.FEAT, att_feat_size=pd.FEAT,
                          max_length=20, compute_dtype=dtype,
                          **dict(pd.MODELS[model], **kw))
    vocab = {str(i): 'w%d' % i for i in range(1, pd.V + 1)}
    return setup(opt, vocab, device).init_params(
        torch.Generator().manual_seed(0))


def train_opt(**kw):
    """The XE trainer's options: the configs' adam 5e-4, the opts.py clip
    by value 0.1, no weight decay, label smoothing or drop-worst."""
    return SimpleNamespace(**dict(dict(
        optim='adam', learning_rate=5e-4, optim_alpha=0.9, optim_beta=0.999,
        optim_epsilon=1e-8, weight_decay=0.0, grad_clip_mode='value',
        grad_clip_value=0.1, noamopt=False, label_smoothing=0.0,
        drop_worst_rate=0.0), **kw))


def rl_opt(**kw):
    """The RL steps' options: ``train_opt``'s, ``train_sample_n`` 5 by
    sampling against the greedy baseline, the CIDEr-D reward, and the
    structure stage's new_self_critical at weight 1."""
    return train_opt(**dict(dict(
        train_sample_n=5, train_sample_method='sample', train_beam_size=1,
        sc_sample_method='greedy', sc_beam_size=1, cider_reward_weight=1.0,
        bleu_reward_weight=0.0, structure_loss_weight=1.0,
        structure_loss_type='new_self_critical', entropy_reward_weight=0.0,
        self_cider_reward_weight=0.0, use_ppo=0), **kw))


def corpus_df(images: int = CORPUS_IMAGES, refs: int = CORPUS_REFS,
              seed: int = 0):
    """(document frequencies, ref_len) as ``scripts/prepro_ngrams.py``
    builds them (each image's set of the 1- to 4-grams of its references
    with the end token '0' appended) over a seeded random corpus in the
    COCO vocabulary, captions of 8..16 words."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(8, L + 1, (images, refs), generator=g).tolist()
    words = torch.randint(1, pd.V + 1, (images, refs, L), generator=g)
    df = {}
    for img, caps in enumerate(words.tolist()):
        grams = set()
        for cap, n_words in zip(caps, lengths[img]):
            toks = [str(w) for w in cap[:n_words]] + ['0']
            for n in range(1, 5):
                grams.update(tuple(toks[k:k + n])
                             for k in range(len(toks) - n + 1))
        for gram in grams:
            df[gram] = df.get(gram, 0.0) + 1.0
    return df, images


def train_batch(B: int, seed: int):
    """fc, att, att_masks, labels, masks of B images x 5 captions of
    8..L tokens, laid out as the loader gives them (a BOS column, a
    trailing 0), on the CPU."""
    fc, att, am = pd.features(B, 'cpu', seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    lengths = torch.randint(8, L + 1, (B, 5), generator=g)
    tok = torch.randint(1, pd.V + 1, (B, 5, L), generator=g)
    labels = torch.zeros(B, 5, L + 2, dtype=torch.long)
    labels[..., 1:L + 1] = torch.where(torch.arange(L) < lengths[..., None],
                                       tok, 0)
    masks = (torch.arange(L + 2) <= lengths[..., None] + 1).float()
    return fc, att, am, labels, masks


def make_step(model: str, device: str = 'cuda', B: int = 10,
              graphed: bool = False, dtype: str = 'float32'):
    """(trainer, step(it) -> loss tensor, the dropout generator) for
    ``model`` trained with its ``TRAIN`` options on one seeded batch;
    ``graphed``: through ``xe_step_graphed``; ``dtype``: the compute
    dtype."""
    from ..modules.trainer import Trainer
    model_kw, opt_kw, ss_prob, lr_fn = TRAIN[model]
    tr = Trainer(train_captioner(model, device, dtype, **model_kw),
                 train_opt(**opt_kw))
    fc, att, am, labels, masks = (x.to(device) for x in train_batch(B, 4))
    gen = torch.Generator(device).manual_seed(6)
    xe = tr.xe_step_graphed if graphed else tr.xe_step

    def step(it):
        return xe(fc, att, labels, masks, am, lr_fn(it), ss_prob,
                  gen)['loss']

    return tr, step, gen


def rl_batch(captioner, B: int, seed: int):
    """``train_batch`` on the captioner's device and its references
    (refs [B, 5, L], ref_mask [B, 5]): the 5 labels of an image, the first
    of them replaced by the captioner's own greedy caption (cut to L - 1
    words and an end), so that a random model's samples share n-grams with
    a reference and the rewards are not all 0."""
    from ..ops.cider_device import pad_gts
    device = captioner.device
    fc, att, am, labels, masks = (x.to(device)
                                  for x in train_batch(B, seed))
    greedy, _ = captioner.sample_stats(fc, att, am, None, {
        'sample_method': 'greedy', 'beam_size': 1})
    gts = labels[:, :, 1:L + 1].cpu().clone()
    gts[:, 0, :L - 1] = greedy[:, :L - 1].cpu()
    gts[:, 0, L - 1] = 0
    refs, ref_mask = (torch.from_numpy(x).to(device)
                      for x in pad_gts(gts.numpy(), pad_to_multiple=5))
    return fc, att, am, labels, masks, refs, ref_mask


def make_rl_step(model: str, mode: str = 'scst', device: str = 'cuda',
                 B: int = 10, scorer=None, graphed: bool = False,
                 dtype: str = 'float32'):
    """(trainer, step(it) -> its output dict, (dropout generator, noise
    generator), the batch (fc, att, am, refs, ref_mask)) for ``model``'s
    fused SCST (``mode`` 'scst') or structure ('struc') step with its
    ``RL`` options, on one seeded batch of B images (``rl_batch``);
    ``scorer`` a ``DeviceCiderD`` on ``device`` (default: over
    ``corpus_df``).  ``mode`` 'scst_grad' takes ``sc_grad_step`` over one
    ``sc_decode`` of the batch made here, its reward from ``scorer``.
    ``graphed``: through the ``*_step_graphed`` entries; ``dtype``: the
    compute dtype."""
    from ..modules.trainer import Trainer
    from ..ops.cider_device import DeviceCiderD
    model_kw, opt_kw = RL[model]
    opt = rl_opt(**opt_kw)
    tr = Trainer(train_captioner(model, device, dtype, **model_kw), opt)
    fc, att, am, labels, masks, refs, ref_mask = rl_batch(tr.captioner, B, 4)
    if scorer is None:
        scorer = DeviceCiderD(*corpus_df(), device=device)
    gen, gen_lm, noise = (torch.Generator(device).manual_seed(k)
                          for k in (6, 7, 8))
    lr = opt.learning_rate
    if mode == 'scst_grad':
        greedy, sampled = tr.sc_decode(
            fc, att, am, None, torch.Generator(device).manual_seed(9), gen)
        reward = scorer.self_critical_reward(greedy, sampled, refs,
                                             ref_mask)
    fused = tr.sc_fused_step_graphed if graphed else tr.sc_fused_step
    grad = tr.sc_grad_step_graphed if graphed else tr.sc_grad_step
    struc = tr.struc_fused_step_graphed if graphed else tr.struc_fused_step

    def step(it):
        if mode == 'scst':
            return fused(fc, att, am, refs, ref_mask, lr, noise, noise, gen,
                         scorer)
        if mode == 'scst_grad':
            return grad(fc, att, am, sampled, reward, lr, gen)
        return struc(fc, att, labels, masks, am, refs, ref_mask, lr, noise,
                     gen, gen_lm, scorer)

    return tr, step, (gen, noise), (fc, att, am, refs, ref_mask)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--model', default='updown', choices=sorted(TRAIN))
    p.add_argument('--mode', default='xe',
                   choices=('xe', 'scst', 'scst_grad', 'struc'))
    p.add_argument('--route', default='eager', choices=('eager', 'graph'))
    p.add_argument('--compute_dtype', default='float32',
                   choices=('float32', 'bfloat16'))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_train: needs a CUDA device')
    if a.mode != 'xe' and a.model not in RL:
        raise SystemExit('profile_train: --mode %s takes --model %s'
                         % (a.mode, '|'.join(sorted(RL))))
    from torch.profiler import ProfilerActivity, profile
    graphed = a.route == 'graph'
    if a.mode == 'xe':
        _, step, _ = make_step(a.model, graphed=graphed,
                               dtype=a.compute_dtype)
    else:
        _, step, _, _ = make_rl_step(a.model, a.mode, graphed=graphed,
                                     dtype=a.compute_dtype)
    it = 0
    for _ in range(WARM):
        it += 1
        step(it)
    torch.cuda.synchronize()
    walls = []
    for _ in range(WALLS):
        it += 1
        t = time.time()
        step(it)
        torch.cuda.synchronize()
        walls.append(1000 * (time.time() - t))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        for _ in range(PROFILED):
            it += 1
            step(it)
        torch.cuda.synchronize()
        wall = 1000 * (time.time() - t) / PROFILED
    # device events of kernels and copies; the optimizer's step is also a
    # user annotation mirrored on the device, over kernels already counted
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    busy = sum(e.self_device_time_total for e in events) / 1000 / PROFILED
    events.sort(key=lambda e: -e.self_device_time_total)
    out = {'model': a.model, 'mode': a.mode, 'route': a.route,
           'compute_dtype': a.compute_dtype, 'batch': '10 x 5',
           'label_length': L,
           'device': torch.cuda.get_device_name(0),
           'step_wall_ms_unprofiled': walls,
           'step_wall_ms_profiled': wall, 'device_busy_ms': busy,
           'idle_share': 1 - busy / wall,
           'kernels': [{'name': e.key[:90], 'calls': e.count // PROFILED,
                        'ms': e.self_device_time_total / 1000 / PROFILED,
                        'share': e.self_device_time_total / 1000 / PROFILED
                        / busy}
                       for e in events[:TOP]]}
    print(json.dumps(out, indent=1))
    return out


if __name__ == '__main__':
    main()
