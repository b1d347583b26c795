"""Command-line / YAML option system.

Flag-for-flag compatible with the reference's
``captioning/utils/opts.py`` (names, defaults, merge
precedence: argparse defaults -> --cfg YAML (with _BASE_) -> --set_cfgs ->
explicit CLI flags re-parsed last), so reference configs and launch commands
work unchanged against the TPU-native stack.

TPU-specific additions live under the "TPU" group and all have safe
defaults (``compute_dtype``, ``att_bucket_sizes``, ``jit_cache_dir``...).
"""

from __future__ import annotations

import argparse


def if_use_feat(caption_model):
    """Which feature streams a model consumes (reference opts.py:5-15)."""
    if caption_model in ['show_tell', 'all_img', 'fc', 'newfc']:
        use_att, use_fc = False, True
    elif caption_model == 'language_model':
        use_att, use_fc = False, False
    elif caption_model in ['updown', 'topdown']:
        use_fc, use_att = True, True
    else:
        use_att, use_fc = True, False
    return use_fc, use_att


def build_parser():
    parser = argparse.ArgumentParser()
    # Data input settings
    parser.add_argument('--input_json', type=str, default='data/coco.json')
    parser.add_argument('--input_fc_dir', type=str, default='data/cocotalk_fc')
    parser.add_argument('--input_att_dir', type=str, default='data/cocotalk_att')
    parser.add_argument('--input_box_dir', type=str, default='data/cocotalk_box')
    parser.add_argument('--input_label_h5', type=str, default='data/coco_label.h5')
    parser.add_argument('--data_in_memory', action='store_true')
    parser.add_argument('--start_from', type=str, default=None)
    parser.add_argument('--cached_tokens', type=str, default='coco-train-idxs')

    # Model settings
    parser.add_argument('--caption_model', type=str, default="show_tell")
    parser.add_argument('--rnn_size', type=int, default=512)
    parser.add_argument('--num_layers', type=int, default=1)
    parser.add_argument('--rnn_type', type=str, default='lstm')
    parser.add_argument('--input_encoding_size', type=int, default=512)
    parser.add_argument('--att_hid_size', type=int, default=512)
    parser.add_argument('--fc_feat_size', type=int, default=2048)
    parser.add_argument('--att_feat_size', type=int, default=2048)
    parser.add_argument('--logit_layers', type=int, default=1)
    parser.add_argument('--use_bn', type=int, default=0)

    # feature manipulation
    parser.add_argument('--norm_att_feat', type=int, default=0)
    parser.add_argument('--use_box', type=int, default=0)
    parser.add_argument('--norm_box_feat', type=int, default=0)

    # Optimization: General
    parser.add_argument('--max_epochs', type=int, default=-1)
    parser.add_argument('--batch_size', type=int, default=16)
    parser.add_argument('--grad_clip_mode', type=str, default='value')
    parser.add_argument('--grad_clip_value', type=float, default=0.1)
    parser.add_argument('--drop_prob_lm', type=float, default=0.5)
    parser.add_argument('--self_critical_after', type=int, default=-1)
    parser.add_argument('--seq_per_img', type=int, default=5)

    # Sample related
    add_eval_sample_opts(parser)

    # Optimization: for the Language Model
    parser.add_argument('--optim', type=str, default='adam')
    parser.add_argument('--learning_rate', type=float, default=4e-4)
    parser.add_argument('--learning_rate_decay_start', type=int, default=-1)
    parser.add_argument('--learning_rate_decay_every', type=int, default=3)
    parser.add_argument('--learning_rate_decay_rate', type=float, default=0.8)
    parser.add_argument('--optim_alpha', type=float, default=0.9)
    parser.add_argument('--optim_beta', type=float, default=0.999)
    parser.add_argument('--optim_epsilon', type=float, default=1e-8)
    parser.add_argument('--weight_decay', type=float, default=0)
    # Transformer
    parser.add_argument('--label_smoothing', type=float, default=0)
    parser.add_argument('--noamopt', action='store_true')
    parser.add_argument('--noamopt_warmup', type=int, default=2000)
    parser.add_argument('--noamopt_factor', type=float, default=1)
    parser.add_argument('--reduce_on_plateau', action='store_true')
    parser.add_argument('--reduce_on_plateau_factor', type=float, default=0.5)
    parser.add_argument('--reduce_on_plateau_patience', type=int, default=3)
    parser.add_argument('--cached_transformer', action='store_true')

    parser.add_argument('--use_warmup', action='store_true')

    parser.add_argument('--scheduled_sampling_start', type=int, default=-1)
    parser.add_argument('--scheduled_sampling_increase_every', type=int, default=5)
    parser.add_argument('--scheduled_sampling_increase_prob', type=float, default=0.05)
    parser.add_argument('--scheduled_sampling_max_prob', type=float, default=0.25)

    # Evaluation/Checkpointing
    parser.add_argument('--val_images_use', type=int, default=3200)
    parser.add_argument('--save_checkpoint_every', type=int, default=2500)
    parser.add_argument('--save_every_epoch', action='store_true')
    parser.add_argument('--save_history_ckpt', type=int, default=0)
    parser.add_argument('--checkpoint_path', type=str, default=None)
    parser.add_argument('--language_eval', type=int, default=0)
    parser.add_argument('--losses_log_every', type=int, default=25)
    parser.add_argument('--load_best_score', type=int, default=1)

    # misc
    parser.add_argument('--id', type=str, default='')
    parser.add_argument('--train_only', type=int, default=0)
    # second logger backend (reference train_pl.py:442-449); optional dep
    parser.add_argument('--use_wandb', type=int, default=0)

    # Reward
    parser.add_argument('--cider_reward_weight', type=float, default=1)
    parser.add_argument('--bleu_reward_weight', type=float, default=0)

    # Structure_loss
    parser.add_argument('--structure_loss_weight', type=float, default=1)
    parser.add_argument('--structure_after', type=int, default=-1)
    parser.add_argument('--structure_loss_type', type=str, default='seqnll')
    parser.add_argument('--struc_use_logsoftmax', action='store_true')
    parser.add_argument('--entropy_reward_weight', type=float, default=0)
    parser.add_argument('--self_cider_reward_weight', type=float, default=0)

    # PPO loss
    parser.add_argument('--use_ppo', type=int, default=0)
    parser.add_argument('--ppo_old_model_path', type=str, default=None)
    parser.add_argument('--ppo_cliprange', type=float, default=0.2)
    parser.add_argument('--ppo_kl_coef', type=float, default=0.02)

    # Used for self critical or structure
    parser.add_argument('--train_sample_n', type=int, default=16)
    parser.add_argument('--train_sample_method', type=str, default='sample')
    parser.add_argument('--train_beam_size', type=int, default=1)

    # Used for self critical
    parser.add_argument('--sc_sample_method', type=str, default='greedy')
    parser.add_argument('--sc_beam_size', type=int, default=1)

    # drop_worst
    parser.add_argument('--drop_worst_after', type=float, default=-1)
    parser.add_argument('--drop_worst_rate', type=float, default=0)

    # For diversity evaluation during training
    add_diversity_opts(parser)

    # TPU-native additions (all optional, safe defaults)
    parser.add_argument('--compute_dtype', type=str, default='float32',
                        help='float32 | bfloat16 compute dtype for model math')
    parser.add_argument('--att_bucket_sizes', type=str, default='',
                        help='comma-separated att-length buckets for static '
                             'shapes, e.g. "36,64,100". Empty = single bucket '
                             'discovered from the data.')
    parser.add_argument('--num_prefetch', type=int, default=4,
                        help='host-side prefetch depth of the input pipeline')
    parser.add_argument('--num_data_threads', type=int, default=4,
                        help='host-side feature-reader threads')
    parser.add_argument('--native_io', type=int, default=1,
                        help='use the C++ batch feature loader '
                             '(native/dataio.cpp) when the dataset qualifies;'
                             ' 0 forces the Python item path')
    parser.add_argument('--mesh_shape', type=str, default='',
                        help='device mesh, e.g. "data:8" or "data:4,model:2". '
                             'Empty = all devices on the data axis. With '
                             'multiple processes the mesh spans the GLOBAL '
                             'device set.')
    parser.add_argument('--dist_coordinator', type=str, default='',
                        help='multi-host training: coordinator address '
                             '"host:port" for jax.distributed.initialize. '
                             'Empty = single-process unless the standard '
                             'cluster env (TPU pod / JAX_COORDINATOR_ADDRESS)'
                             ' is present and --dist_auto is set. Replaces '
                             'the reference\'s Lightning DDP launch '
                             '(train_pl.py:458-499).')
    parser.add_argument('--dist_nproc', type=int, default=-1,
                        help='multi-host: total process count (with '
                             '--dist_coordinator; -1 = auto-detect)')
    parser.add_argument('--dist_pid', type=int, default=-1,
                        help='multi-host: this process\'s id (with '
                             '--dist_coordinator; -1 = auto-detect)')
    parser.add_argument('--dist_auto', type=int, default=0,
                        help='call jax.distributed.initialize() with no '
                             'arguments (auto-detects TPU pod / SLURM / '
                             'JAX_COORDINATOR_ADDRESS environments)')
    parser.add_argument('--use_pallas', type=int, default=-1,
                        help='pallas fused kernels: 1 = on, 0 = off, '
                             '-1 (default) = auto (on when the backend is '
                             'TPU; off elsewhere).  Covers the fused '
                             'additive-attention kernel (RNN families) and '
                             'the fused beam/greedy decode attend '
                             '(transformer; eval decode only — captions '
                             'can differ from the jnp path at exact bf16 '
                             'logit ties, see BENCH.md)')
    parser.add_argument('--on_device_cider', type=int, default=-1,
                        help='fuse the whole SCST/structure iteration '
                             '(decode + CIDEr-D reward + grad) into one '
                             'jitted program using the on-device scorer. '
                             '-1 (default) = auto: on whenever the reward '
                             'is pure CIDEr (no bleu/self-cider weight, no '
                             'drop-worst); 0 = force the host-reward path; '
                             '1 = on when eligible')
    parser.add_argument('--compilation_cache_dir', type=str, default='',
                        help='persistent XLA compilation cache directory; '
                             'large decode programs compile in minutes cold '
                             'but load in seconds warm. Empty = disabled.')
    parser.add_argument('--seed', type=int, default=42,
                        help='base PRNG seed for training (dropout, '
                             'sampling, scheduled sampling). The torch '
                             'reference never seeds; a seed is what makes '
                             'jit-compiled runs reproducible here.')
    parser.add_argument('--rng_impl', type=str, default='rbg',
                        help='JAX PRNG implementation for TRAINING: rbg '
                             '(fast TPU generator, the default — '
                             'dropout-mask generation is ~6x cheaper, XE '
                             'step ~1.4x faster end-to-end) | '
                             'threefry2x32 (the JAX default splittable '
                             'PRNG). Streams differ between impls; both '
                             'are statistically sound for dropout/'
                             'sampling. Decode-only paths measured ~10%% '
                             'SLOWER under rbg, so eval defaults to '
                             'threefry (see add_eval_options).')

    # config
    parser.add_argument('--cfg', type=str, default=None)
    parser.add_argument('--set_cfgs', dest='set_cfgs', default=[], nargs='+')
    return parser


def parse_opt(args_list=None):
    """Parse options with reference-identical precedence (opts.py:239-253)."""
    parser = build_parser()
    args = parser.parse_args(args_list)
    if args.cfg is not None or args.set_cfgs is not None:
        from .config import CfgNode
        if args.cfg is not None:
            cn = CfgNode(CfgNode.load_yaml_with_base(args.cfg))
        else:
            cn = CfgNode()
        if args.set_cfgs is not None:
            cn.merge_from_list(args.set_cfgs)
        for k, v in cn.items():
            if not hasattr(args, k):
                print('Warning: key %s not in args' % k)
            setattr(args, k, v)
        args = parser.parse_args(args_list, namespace=args)

    # Validation block (reference opts.py:256-267)
    assert args.rnn_size > 0, "rnn_size should be greater than 0"
    assert args.num_layers > 0, "num_layers should be greater than 0"
    assert args.input_encoding_size > 0, "input_encoding_size should be greater than 0"
    assert args.batch_size > 0, "batch_size should be greater than 0"
    assert 0 <= args.drop_prob_lm < 1, "drop_prob_lm should be between 0 and 1"
    assert args.seq_per_img > 0, "seq_per_img should be greater than 0"
    assert args.beam_size > 0, "beam_size should be greater than 0"
    assert args.save_checkpoint_every > 0, "save_checkpoint_every should be greater than 0"
    assert args.losses_log_every > 0, "losses_log_every should be greater than 0"
    assert args.language_eval in (0, 1), "language_eval should be 0 or 1"
    assert args.load_best_score in (0, 1), "load_best_score should be 0 or 1"
    assert args.train_only in (0, 1), "train_only should be 0 or 1"

    # default value for start_from and checkpoint_path (opts.py:270-271)
    args.checkpoint_path = args.checkpoint_path or './log_%s' % args.id
    args.start_from = args.start_from or args.checkpoint_path

    # Deal with feature things before anything (opts.py:274-275)
    args.use_fc, args.use_att = if_use_feat(args.caption_model)
    if args.use_box:
        args.att_feat_size = args.att_feat_size + 5

    return args


def add_eval_options(parser):
    """Options specific to tools/eval.py (reference opts.py:280-324)."""
    parser.add_argument('--batch_size', type=int, default=0)
    parser.add_argument('--compilation_cache_dir', type=str, default='',
                        help='persistent XLA compilation cache directory')
    parser.add_argument('--rng_impl', type=str, default='',
                        help='JAX PRNG implementation (rbg | threefry2x32).'
                             ' Empty = JAX default threefry2x32: decode '
                             'measured ~10%% slower under rbg (rbg is the '
                             'TRAINING default where dropout-mask '
                             'generation dominates the rng cost)')
    parser.add_argument('--device_mesh', type=int, default=0,
                        help='shard eval decode batches over all local '
                             'devices (single-process multi-chip; TPU-only '
                             'extension, no reference analogue)')
    parser.add_argument('--num_images', type=int, default=-1)
    parser.add_argument('--language_eval', type=int, default=0)
    parser.add_argument('--dump_images', type=int, default=1)
    parser.add_argument('--dump_json', type=int, default=1)
    parser.add_argument('--dump_path', type=int, default=0)

    add_eval_sample_opts(parser)

    parser.add_argument('--image_folder', type=str, default='')
    parser.add_argument('--image_root', type=str, default='')
    parser.add_argument('--input_fc_dir', type=str, default='')
    parser.add_argument('--input_att_dir', type=str, default='')
    parser.add_argument('--input_box_dir', type=str, default='')
    parser.add_argument('--input_label_h5', type=str, default='')
    parser.add_argument('--input_json', type=str, default='')
    parser.add_argument('--split', type=str, default='test')
    parser.add_argument('--coco_json', type=str, default='')
    parser.add_argument('--id', type=str, default='')
    parser.add_argument('--verbose_beam', type=int, default=1)
    parser.add_argument('--verbose_loss', type=int, default=0)


def add_diversity_opts(parser):
    parser.add_argument('--sample_n', type=int, default=1)
    parser.add_argument('--sample_n_method', type=str, default='sample')
    parser.add_argument('--eval_oracle', type=int, default=1)


def add_eval_sample_opts(parser):
    parser.add_argument('--sample_method', type=str, default='greedy')
    parser.add_argument('--beam_size', type=int, default=1)
    parser.add_argument('--max_length', type=int, default=20)
    parser.add_argument('--length_penalty', type=str, default='')
    parser.add_argument('--group_size', type=int, default=1)
    parser.add_argument('--diversity_lambda', type=float, default=0.5)
    parser.add_argument('--temperature', type=float, default=1.0)
    parser.add_argument('--decoding_constraint', type=int, default=0)
    parser.add_argument('--block_trigrams', type=int, default=0)
    parser.add_argument('--remove_bad_endings', type=int, default=0)
    parser.add_argument('--suppress_UNK', type=int, default=1)
