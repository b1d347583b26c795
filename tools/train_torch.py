"""XE training entry point of the PyTorch port (counterpart of tools/train.py).

The XE loop of tools/train.py on one device: the epoch-wise learning-rate
decay, warmup, noam and plateau schedules, the scheduled-sampling ramp and
drop-worst; every ``save_checkpoint_every`` iterations (or epoch) the val
``eval_split``, the ``-best`` selection and the checkpoint; ``--start_from``
resume (infos, histories, model, optimizer and loader state); a checkpoint
on an exception; the optional tensorboard and wandb writers.  It runs on
``--device`` (cuda by default, where the CUDA kernels build at first use;
``--device cpu`` runs the kernels' plain twins) and raises with
``--device cuda`` and no GPU.  The checkpoints keep the JAX package's
contract (``model[-best|-<iter>].npz``, ``optimizer*.npz`` in the optax
layout, ``infos_<id>*.pkl``, ``histories_<id>*.pkl``): tools/eval.py and
tools/train.py read them, and this script resumes theirs.

SCST and structure training (``self_critical_after`` / ``structure_after``
reached), PPO, bf16 training, a mesh and multi-host runs raise and name
their ROADMAP.md item.

    python tools/train_torch.py --cfg configs/updown/updown.yml \\
        --id updown --checkpoint_path log_updown [--device cpu]
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
from captioning_tpu_torch.utils import eval_utils  # noqa: E402
from captioning_tpu_torch.utils import optimizers as optim_utils  # noqa: E402


def _summary_writer(path):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:  # tensorboard optional
        return None
    return SummaryWriter(path)


def _refuse_unported(opt):
    """Options of tools/train.py that this loop does not port."""
    if getattr(opt, 'mesh_shape', '') or getattr(opt, 'dist_coordinator',
                                                 '') or \
            getattr(opt, 'dist_auto', 0) or \
            getattr(opt, 'dist_nproc', -1) not in (None, -1, 1):
        raise NotImplementedError('a mesh and multi-host training are not '
                                  'ported yet; see ROADMAP.md A7')
    if getattr(opt, 'use_ppo', 0):
        raise NotImplementedError('PPO is not ported yet; see ROADMAP.md A5')
    if getattr(opt, 'compute_dtype', 'float32') != 'float32':
        raise NotImplementedError('training in %s needs float32 master '
                                  'weights, not ported yet; see ROADMAP.md '
                                  '(train with --compute_dtype float32)'
                                  % opt.compute_dtype)


def train(opt, device='cuda'):
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(pass --device cpu to run the plain twins)')
    _refuse_unported(opt)
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

    tb_writer = _summary_writer(opt.checkpoint_path)

    # wandb (second logger backend, reference train_pl.py:442-449):
    # optional dependency, enabled by --use_wandb, silent no-op otherwise
    wandb_run = None
    if getattr(opt, 'use_wandb', 0):
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
    # dropout and scheduled sampling draw from this stream
    gen = torch.Generator(captioner.device).manual_seed(seed + 1)

    ##########################
    # Build optimizer
    ##########################
    if opt.noamopt and opt.caption_model not in ('transformer', 'bert',
                                                 'm2transformer'):
        raise ValueError('noamopt can only work with transformer')
    trainer = Trainer(captioner, opt)
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
        utils.save_checkpoint(opt, captioner.jax_variables(), infos,
                              trainer.opt_state_jax(),
                              None if append else histories, append=append)

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
    drop_worst_flag = False
    opt.current_lr = opt.learning_rate
    ss_prob = 0.0
    d_model = getattr(opt, 'd_model', opt.input_encoding_size)

    def dev(x, dtype):
        return None if x is None else torch.as_tensor(
            np.asarray(x), dtype=dtype).to(captioner.device)

    pending = None  # the last step's record, its loss read one step later

    def flush_metrics(p):
        """Print and log a completed step's loss, read after the next step
        has been queued, so the host waits on the device no more than the
        JAX loop does."""
        train_loss = float(p['out']['loss'])
        print("iter {} (epoch {}), train_loss = {:.3f}, time/batch = "
              "{:.3f}".format(p['it'], p['epoch'], train_loss,
                              time.time() - p['start']))
        it1 = p['it'] + 1
        # Write the training loss summary (train.py:216-235)
        if it1 % opt.losses_log_every == 0:
            tb_add('train_loss', train_loss, it1)
            tb_add('learning_rate', p['lr'], it1)
            tb_add('scheduled_sampling_prob', p['ss_prob'], it1)
            histories['loss_history'][it1] = train_loss
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
                # self-critical / structure stages (train.py:149-165)
                for flag in ('self_critical_after', 'structure_after'):
                    after = getattr(opt, flag)
                    if after != -1 and epoch >= after:
                        raise NotImplementedError(
                            '%s %d reached at epoch %d: SCST and structure '
                            'training are not ported yet; see ROADMAP.md A5'
                            % (flag, after, epoch))
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
            print('Read data:', time.time() - start)

            start = time.time()
            out = trainer.xe_step(
                dev(data['fc_feats'], torch.float32),
                dev(data['att_feats'], torch.float32),
                dev(data['labels'], torch.long),
                dev(data['masks'], torch.float32),
                dev(data['att_masks'], torch.float32),
                opt.current_lr, ss_prob, gen,
                drop_worst_flag=drop_worst_flag)

            new_pending = {'out': out, 'it': iteration, 'epoch': epoch,
                           'start': start, 'lr': opt.current_lr,
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
        print('Save ckpt on exception ...')
        utils.save_checkpoint(opt, captioner.jax_variables(), infos,
                              trainer.opt_state_jax())
        print('Save ckpt done.')
        stack_trace = traceback.format_exc()
        print(stack_trace)
        if isinstance(e, NotImplementedError):
            raise          # an unported stage: the run cannot go on


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--device', type=str, default='cuda',
                     choices=('cuda', 'cpu'))
    known, rest = pre.parse_known_args(argv)
    train(opts.parse_opt(rest), device=known.device)


if __name__ == '__main__':
    main()
