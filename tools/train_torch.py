"""Training entry point of the PyTorch port (counterpart of tools/train.py).

The loop of tools/train.py on one device: XE, then the SCST stage from
``self_critical_after`` and the structure-loss stage (PPO with
``use_ppo``) from ``structure_after``; the epoch-wise learning-rate
decay, warmup, noam and plateau schedules, the scheduled-sampling ramp and
drop-worst.  An RL iteration is one fused step on the card (the reward
from ``ops/cider_device.py``) when the reward has a CIDEr or BLEU weight
(``--on_device_cider`` -1, the default, or 1) and drop-worst is off;
otherwise it decodes, scores on the host (the native C++ CIDEr-D scorer
where the reward is CIDEr alone and the library builds, else the python
scorers) and takes the grad step.  Every ``save_checkpoint_every``
iterations (or epoch) the val
``eval_split``, the ``-best`` selection and the checkpoint; ``--start_from``
resume (infos, histories, model, optimizer and loader state); a checkpoint
on an exception; the optional tensorboard and wandb writers.  It runs on
``--device`` (cuda by default, where the CUDA kernels build at first use;
``--device cpu`` runs the kernels' plain twins) and raises with
``--device cuda`` and no GPU.  Each step goes through the trainer's
graphed entry (``xe_step_graphed``, ``sc_fused_step_graphed``, ...: one
CUDA graph a step on the card, the same step run eagerly on the CPU) where
``Trainer.graph_route`` allows it, else through the eager one; the route
of each step kind is printed once, with the reason where it stays eager.
The checkpoints keep the JAX package's contract (``model[-best|-<iter>].npz``, ``optimizer*.npz`` in the optax
layout, ``infos_<id>*.pkl``, ``histories_<id>*.pkl``): tools/eval.py and
tools/train.py read them, and this script resumes theirs.

``--compute_dtype bfloat16`` trains with float32 master weights: the model
computes in bf16 at the JAX package's cast sites, while the parameters,
their gradients, the optimizer state and the checkpoints stay float32.

Data-parallel over several processes, one a rank (``parallel/mesh.py``):
``--dist_coordinator host:port --dist_nproc N --dist_pid i`` joins a
group, ``--dist_auto 1`` joins torchrun's, and ``--mesh_shape data:N`` (or,
with none, several visible GPUs: the largest count that divides
``batch_size``) starts the N ranks itself (``parallel/launch.py``).
``--batch_size`` is global: every rank reads the same batches and steps on
its ``local_batch_slice``; each step is the one-device step over the
global batch (``modules/trainer.py``), the val eval is cooperative, and
rank 0 alone writes the checkpoints, infos, histories and tensorboard
while the others wait.  A failing rank fails the run.  The model axis
(``--mesh_shape data:N,model:M``): N * M ranks, the M of a model group
reading the same rows and holding the shards of the vocab tensors
(``Captioner.shard_vocab``); the ranks of a data group are seeded alike
and the checkpoints hold the full arrays, gathered.

    python tools/train_torch.py --cfg configs/updown/updown.yml \\
        --id updown --checkpoint_path log_updown [--device cpu]
    python tools/train_torch.py ... --mesh_shape data:4
    python tools/train_torch.py ... --mesh_shape data:2,model:2
    torchrun --nproc_per_node 4 tools/train_torch.py ... --dist_auto 1
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import captioning_tpu_torch.utils.misc as utils  # noqa: E402
import captioning_tpu_torch.utils.opts as opts  # noqa: E402
from captioning_tpu_torch.data.dataset import DataLoader  # noqa: E402
from captioning_tpu_torch.models.api import setup  # noqa: E402
from captioning_tpu_torch.modules.trainer import Trainer  # noqa: E402
from captioning_tpu_torch.parallel import launch, mesh  # noqa: E402
from captioning_tpu_torch.utils import eval_utils  # noqa: E402
from captioning_tpu_torch.utils import optimizers as optim_utils  # noqa: E402
from captioning_tpu_torch.utils.rewards import (  # noqa: E402
    get_scores, get_self_cider_scores, get_self_critical_reward, init_scorer)


def _summary_writer(path):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:  # tensorboard optional
        return None
    return SummaryWriter(path)


def train(opt, device='cuda'):
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(pass --device cpu to run the plain twins)')
    # a malformed mesh shape raises before the group is joined
    mesh.parse_mesh_shape(getattr(opt, 'mesh_shape', '') or '')
    device = mesh.init_distributed(opt, device)
    try:
        _train(opt, device, mesh.make_mesh(opt.mesh_shape))
    finally:
        if mesh.world_size() > 1:
            torch.distributed.destroy_process_group()


def _train(opt, device, grid):
    main = grid.rank == 0

    def say(*args):
        """Print on rank 0 only: the ranks' steps report the same global
        values."""
        if main:
            print(*args)
    ################################
    # Build dataloader
    ################################
    loader = DataLoader(opt)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length

    ##########################
    # Initialize infos
    ##########################
    infos = {
        'iter': 0,
        'epoch': 0,
        'loader_state_dict': None,
        'vocab': loader.get_vocab(),
    }
    if opt.start_from is not None and os.path.isfile(
            os.path.join(opt.start_from, 'infos_' + opt.id + '.pkl')):
        with open(os.path.join(opt.start_from,
                               'infos_' + opt.id + '.pkl'), 'rb') as f:
            infos = utils.pickle_load(f)
            saved_model_opt = infos['opt']
            need_be_same = ["caption_model", "rnn_type", "rnn_size",
                            "num_layers"]
            for checkme in need_be_same:
                if getattr(saved_model_opt, checkme) != getattr(opt,
                                                                checkme):
                    raise ValueError("Command line argument and saved model "
                                     "disagree on '%s'" % checkme)
    infos['opt'] = opt

    histories = defaultdict(dict)
    if opt.start_from is not None and os.path.isfile(
            os.path.join(opt.start_from, 'histories_' + opt.id + '.pkl')):
        with open(os.path.join(opt.start_from,
                               'histories_' + opt.id + '.pkl'), 'rb') as f:
            histories.update(utils.pickle_load(f))

    tb_writer = _summary_writer(opt.checkpoint_path) if main else None

    # wandb (second logger backend, reference train_pl.py:442-449):
    # optional dependency, enabled by --use_wandb, silent no-op otherwise
    wandb_run = None
    if getattr(opt, 'use_wandb', 0) and main:
        try:
            import wandb
            wandb_run = wandb.init(
                name=opt.id, id=opt.id, project='captioning',
                dir=opt.checkpoint_path, config=vars(opt), resume='allow')
        except Exception as e:
            print('wandb unavailable, continuing without it:', e)

    def tb_add(key, value, it):
        if tb_writer:
            tb_writer.add_scalar(key, value, it)
        if wandb_run:
            wandb_run.log({key: value}, step=it)

    ##########################
    # Build model
    ##########################
    seed = getattr(opt, 'seed', None)
    seed = 42 if seed is None else int(seed)
    captioner = setup(opt, loader.get_vocab(), device=device)
    if opt.start_from is not None and os.path.isfile(
            os.path.join(opt.start_from, 'model.npz')):
        captioner.load_params(os.path.join(opt.start_from, 'model.npz'))
        print('loaded model from', opt.start_from)
    else:
        captioner.init_params(torch.Generator().manual_seed(seed))
    captioner.replicate()              # rank 0's weights on every rank
    captioner.shard_vocab(grid)        # a model axis's shards, by the rule
    # dropout and scheduled sampling draw from gen; the structure steps'
    # XE term from gen_lm, the RL sampling noise from noise; each data
    # index from its own seeds, so that its rows do not repeat another's
    # masks, and the ranks of a model group alike (they read the same rows)
    gen, gen_lm, noise = (torch.Generator(captioner.device).manual_seed(
        seed + k + 3 * grid.data_index) for k in (1, 2, 3))

    # PPO old model
    old_captioner = None
    if getattr(opt, 'use_ppo', 0):
        if opt.ppo_old_model_path is None:
            raise ValueError('Must provide old model path for PPO')
        old_captioner = setup(opt, loader.get_vocab(),
                              device=device).load_params(
                                  opt.ppo_old_model_path).replicate()

    ##########################
    # Build optimizer
    ##########################
    if opt.noamopt and opt.caption_model not in ('transformer', 'bert',
                                                 'm2transformer'):
        raise ValueError('noamopt can only work with transformer')
    trainer = Trainer(captioner, opt, old_captioner=old_captioner)
    routes = {}

    def step_fn(kind):
        """The trainer's entry for the step ``kind``: the graphed one where
        its route allows, else the eager one; the choice printed once."""
        if kind not in routes:
            why = trainer.graph_route(kind)
            routes[kind] = getattr(trainer, '%s_step%s' % (
                kind, '' if why else '_graphed'))
            if why:
                say('train step %s: eager (%s_step): %s' % (kind, kind,
                                                            why))
            else:
                say('train step %s: %s_step_graphed (%s)' % (
                    kind, kind, 'one CUDA graph a step'
                    if captioner.device.type == 'cuda'
                    else 'run eagerly on the CPU'))
        return routes[kind]
    if opt.start_from is not None and os.path.isfile(
            os.path.join(opt.start_from, 'optimizer.npz')):
        trainer.load_opt_state_jax(utils.load_flat(
            os.path.join(opt.start_from, 'optimizer.npz')))

    plateau = None
    if opt.reduce_on_plateau:
        plateau = optim_utils.ReduceLROnPlateau(
            opt.learning_rate, factor=opt.reduce_on_plateau_factor,
            patience=opt.reduce_on_plateau_patience)
        plateau.load_state_dict(infos.get('plateau_state_dict'))

    def save(append=''):
        """Rank 0 writes (the ranks meet at a barrier after the saves); a
        model axis's shards are gathered on every rank first."""
        if main or captioner.vocab_shards:
            variables, opt_state = (captioner.jax_variables(),
                                    trainer.opt_state_jax())
        if main:
            utils.save_checkpoint(opt, variables, infos, opt_state,
                                  None if append else histories,
                                  append=append)

    #########################
    # Get ready to start
    #########################
    iteration = infos['iter']
    epoch = infos['epoch']
    loader.load_state_dict(infos['loader_state_dict'])
    best_val_score = None
    if opt.load_best_score == 1:
        best_val_score = infos.get('best_val_score', None)

    epoch_done = True
    sc_flag = struc_flag = drop_worst_flag = False
    opt.current_lr = opt.learning_rate
    ss_prob = 0.0
    d_model = getattr(opt, 'd_model', opt.input_encoding_size)
    native_scorer = None
    device_scorer = None

    def get_native_scorer():
        """The C++ CIDEr-D scorer, where the reward is CIDEr alone (a BLEU
        weight takes the python scorers), or None where it does not
        build."""
        nonlocal native_scorer
        if native_scorer is None and opt.cider_reward_weight > 0 and \
                opt.bleu_reward_weight == 0:
            try:
                from captioning_tpu_torch.utils.cider_native import \
                    NativeCiderD
                native_scorer = NativeCiderD(opt.cached_tokens)
                print('using native C++ CIDEr-D scorer')
            except Exception as e:
                print('native CIDEr-D unavailable (%s); python fallback' % e)
                native_scorer = False
        return native_scorer or None

    def get_device_scorer(what):
        nonlocal device_scorer
        if device_scorer is None:
            from captioning_tpu_torch.ops.cider_device import DeviceCiderD
            device_scorer = DeviceCiderD(opt.cached_tokens,
                                         device=captioner.device)
            print('using on-device CIDEr-D (fused %s step)' % what)
        return device_scorer

    def dev(x, dtype):
        return None if x is None else torch.as_tensor(
            np.asarray(x), dtype=dtype).to(captioner.device)

    def device_refs(gts):
        from captioning_tpu_torch.ops.cider_device import pad_gts
        refs, ref_mask = pad_gts(gts, pad_to_multiple=5)
        return dev(refs, torch.long), dev(ref_mask, torch.float32)

    pending = None  # the last step's record, its loss read one step later

    def flush_metrics(p):
        """Print and log a completed step's metrics, read after the next
        step has been queued, so the host waits on the device no more than
        the JAX loop does."""
        out = p['out']
        train_loss = float(out['loss'])
        took = time.time() - p['start']
        if p['struc_flag']:
            say("iter {} (epoch {}), train_loss = {:.3f}, lm_loss = "
                "{:.3f}, struc_loss = {:.3f}, time/batch = {:.3f}"
                .format(p['it'], p['epoch'], train_loss,
                        float(out['lm_loss']), float(out['struc_loss']),
                        took))
        elif not p['sc_flag']:
            say("iter {} (epoch {}), train_loss = {:.3f}, time/batch = "
                "{:.3f}".format(p['it'], p['epoch'], train_loss, took))
        else:
            say("iter {} (epoch {}), avg_reward = {:.3f}, time/batch = "
                "{:.3f}".format(p['it'], p['epoch'], float(out['reward']),
                                took))
        it1 = p['it'] + 1
        # Write the training loss summary (train.py:216-235)
        if it1 % opt.losses_log_every == 0:
            tb_add('train_loss', train_loss, it1)
            tb_add('learning_rate', p['lr'], it1)
            tb_add('scheduled_sampling_prob', p['ss_prob'], it1)
            if p['sc_flag']:
                tb_add('avg_reward', float(out['reward']), it1)
            elif p['struc_flag']:
                reward = out['reward'].cpu().numpy()
                tb_add('lm_loss', float(out['lm_loss']), it1)
                tb_add('struc_loss', float(out['struc_loss']), it1)
                tb_add('reward', float(reward.mean()), it1)
                tb_add('reward_var', float(reward.var(1).mean()), it1)
            histories['loss_history'][it1] = (
                train_loss if not p['sc_flag'] else float(out['reward']))
            histories['lr_history'][it1] = p['lr']
            histories['ss_prob_history'][it1] = p['ss_prob']

    try:
        while True:
            if epoch >= opt.max_epochs and opt.max_epochs != -1:
                break

            if epoch_done:
                if not opt.noamopt and not opt.reduce_on_plateau:
                    opt.current_lr = optim_utils.epoch_decay_lr(opt, epoch)
                # scheduled sampling prob (train.py:144-147)
                if (opt.scheduled_sampling_start >= 0 and
                        epoch > opt.scheduled_sampling_start):
                    frac = ((epoch - opt.scheduled_sampling_start) //
                            opt.scheduled_sampling_increase_every)
                    ss_prob = min(opt.scheduled_sampling_increase_prob * frac,
                                  opt.scheduled_sampling_max_prob)
                opt.ss_prob = ss_prob
                # self-critical / structure flags (train.py:149-165)
                if (opt.self_critical_after != -1 and
                        epoch >= opt.self_critical_after):
                    sc_flag = True
                    init_scorer(opt.cached_tokens)
                else:
                    sc_flag = False
                if (opt.structure_after != -1 and
                        epoch >= opt.structure_after):
                    struc_flag = True
                    init_scorer(opt.cached_tokens)
                else:
                    struc_flag = False
                drop_worst_flag = (opt.drop_worst_after != -1 and
                                   epoch >= opt.drop_worst_after)
                epoch_done = False

            start = time.time()
            if opt.noamopt:
                opt.current_lr = optim_utils.noam_rate(
                    iteration + 1, d_model, opt.noamopt_factor,
                    opt.noamopt_warmup)
            elif opt.reduce_on_plateau:
                opt.current_lr = plateau.current_lr
            # warmup is a no-op under noamopt: the reference sets it, then
            # NoamOpt.step() overwrites the param-group lr every iteration
            # (reference train.py:170-172 + misc.py:170-177)
            if (opt.use_warmup and not opt.noamopt
                    and iteration < opt.noamopt_warmup):
                opt.current_lr = (opt.learning_rate * (iteration + 1) /
                                  opt.noamopt_warmup)

            data = loader.get_batch('train')
            say('Read data:', time.time() - start)
            if grid.data > 1:
                # every rank read the same global batch: keep this data
                # index's rows (tools/train.py _to_jnp's local_slice)
                sl = mesh.local_batch_slice(len(data['infos']))
                data = dict(data, gts=data['gts'][sl], **{
                    k: None if data[k] is None else data[k][sl]
                    for k in ('fc_feats', 'att_feats', 'att_masks',
                              'labels', 'masks')})

            start = time.time()
            fc = dev(data['fc_feats'], torch.float32)
            att = dev(data['att_feats'], torch.float32)
            am = dev(data['att_masks'], torch.float32)
            labels = dev(data['labels'], torch.long)
            masks = dev(data['masks'], torch.float32)
            # --on_device_cider: -1 auto / 1 on / 0 off.  Auto takes the
            # fused step whenever the reward has a CIDEr or BLEU weight
            # (the self-CIDEr reward runs on the card too); drop-worst
            # keeps the host path (its per-sample loss sort needs the
            # unfused step)
            fused = (getattr(opt, 'on_device_cider', -1) != 0 and
                     (opt.cider_reward_weight > 0 or
                      opt.bleu_reward_weight > 0) and not drop_worst_flag)
            if struc_flag and fused:
                refs, ref_mask = device_refs(data['gts'])
                out = step_fn('struc_fused')(
                    fc, att, labels, masks, am, refs, ref_mask,
                    opt.current_lr, noise, gen, gen_lm,
                    get_device_scorer('structure'))
            elif struc_flag:
                gen_seq = trainer.struc_decode(fc, att, am, noise, gen)
                gen_np = gen_seq.cpu().numpy()
                if opt.structure_loss_weight > 0:
                    nat = get_native_scorer()
                    if nat is not None:
                        from captioning_tpu_torch.utils.cider_native \
                            import native_get_scores
                        scores = native_get_scores(nat, data['gts'], gen_np,
                                                   opt.cider_reward_weight)
                    else:
                        scores = get_scores(data['gts'], gen_np, opt)
                else:
                    scores = np.zeros((gen_np.shape[0],), np.float32)
                if getattr(opt, 'self_cider_reward_weight', 0) > 0:
                    sc_scores = get_self_cider_scores(data['gts'], gen_np,
                                                      opt)
                else:
                    sc_scores = np.zeros((len(data['gts']),), np.float32)
                out = step_fn('struc_grad')(
                    fc, att, labels, masks, am, gen_seq,
                    dev(scores, torch.float32), dev(sc_scores, torch.float32),
                    opt.current_lr, gen, gen_lm,
                    drop_worst_flag=drop_worst_flag)
            elif not sc_flag:
                out = step_fn('xe')(fc, att, labels, masks, am,
                                    opt.current_lr, ss_prob, gen,
                                    drop_worst_flag=drop_worst_flag)
            elif fused:
                refs, ref_mask = device_refs(data['gts'])
                out = step_fn('sc_fused')(
                    fc, att, am, refs, ref_mask, opt.current_lr, noise,
                    noise, gen, get_device_scorer('SCST'))
            else:
                greedy_seq, gen_seq = trainer.sc_decode(fc, att, am, noise,
                                                        noise, gen)
                nat = get_native_scorer()
                if nat is not None:
                    from captioning_tpu_torch.utils.cider_native import \
                        native_self_critical_reward
                    reward = native_self_critical_reward(
                        nat, greedy_seq.cpu().numpy(), data['gts'],
                        gen_seq.cpu().numpy(), opt.cider_reward_weight)
                else:
                    reward = get_self_critical_reward(
                        greedy_seq.cpu().numpy(), data['gts'],
                        gen_seq.cpu().numpy(), opt)
                out = step_fn('sc_grad')(
                    fc, att, am, gen_seq, dev(reward, torch.float32),
                    opt.current_lr, gen, drop_worst_flag=drop_worst_flag)
                out['reward'] = mesh.global_mean(float(reward[:, 0].sum()),
                                                 reward.shape[0],
                                                 grid.data_group)

            new_pending = {'out': out, 'it': iteration, 'epoch': epoch,
                           'start': start, 'sc_flag': sc_flag,
                           'struc_flag': struc_flag, 'lr': opt.current_lr,
                           'ss_prob': ss_prob}
            if pending is not None:
                flush_metrics(pending)
            pending = new_pending

            iteration += 1
            if data['bounds']['wrapped']:
                epoch += 1
                epoch_done = True

            infos['iter'] = iteration
            infos['epoch'] = epoch
            infos['loader_state_dict'] = loader.state_dict()

            # Evaluate + checkpoint (train.py:243-285)
            if ((iteration % opt.save_checkpoint_every == 0 and
                 not opt.save_every_epoch) or
                    (epoch_done and opt.save_every_epoch)):
                # catch the deferred metrics up so histories are complete
                # in the checkpoint
                if pending is not None:
                    flush_metrics(pending)
                    pending = None
                eval_kwargs = {'split': 'val', 'dataset': opt.input_json}
                eval_kwargs.update(vars(opt))
                val_loss, predictions, lang_stats = eval_utils.eval_split(
                    captioner, loader, eval_kwargs)

                if opt.reduce_on_plateau:
                    if lang_stats is not None and 'CIDEr' in lang_stats:
                        plateau.step(-lang_stats['CIDEr'])
                    else:
                        plateau.step(val_loss)
                tb_add('validation loss', val_loss, iteration)
                if lang_stats is not None:
                    for k, v in lang_stats.items():
                        if isinstance(v, (int, float)):
                            tb_add(k, v, iteration)
                histories['val_result_history'][iteration] = {
                    'loss': val_loss, 'lang_stats': lang_stats,
                    'predictions': predictions}

                if opt.language_eval == 1:
                    current_score = lang_stats['CIDEr']
                else:
                    current_score = -val_loss

                best_flag = False
                if best_val_score is None or current_score > best_val_score:
                    best_val_score = current_score
                    best_flag = True

                infos['best_val_score'] = best_val_score
                if plateau is not None:
                    infos['plateau_state_dict'] = plateau.state_dict()

                save()
                if opt.save_history_ckpt:
                    save(str(epoch) if opt.save_every_epoch
                         else str(iteration))
                if best_flag:
                    save('best')
                mesh.barrier()

        if pending is not None:
            flush_metrics(pending)
            pending = None

    except (RuntimeError, KeyboardInterrupt) as e:
        # catch the deferred metrics up so the exception checkpoint's
        # histories have no gap (guarded: the pending step itself may be
        # what raised)
        try:
            if pending is not None:
                flush_metrics(pending)
                pending = None
        except Exception:
            pass
        if main and not captioner.vocab_shards:
            # (a model axis's shards would need the other ranks, which
            # may be gone)
            print('Save ckpt on exception ...')
            utils.save_checkpoint(opt, captioner.jax_variables(), infos,
                                  trainer.opt_state_jax())
            print('Save ckpt done.')
        stack_trace = traceback.format_exc()
        print(stack_trace)
        if isinstance(e, NotImplementedError) or grid.world > 1:
            # an unported stage cannot go on; a rank that failed fails the
            # run (the others would wait for it in a collective)
            raise


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--device', type=str, default='cuda',
                     choices=('cuda', 'cpu'))
    known, rest = pre.parse_known_args(argv)
    opt = opts.parse_opt(rest)
    n = launch.ranks_to_start(opt, known.device)
    if n > 1:
        # this launch starts the ranks and waits for them
        rc = launch.run_ranks(os.path.abspath(__file__),
                              ['--device', known.device] + rest, n)
        if rc:
            raise SystemExit('a rank of %d failed (exit code %d)' % (n, rc))
        return
    train(opt, device=known.device)


if __name__ == '__main__':
    main()
