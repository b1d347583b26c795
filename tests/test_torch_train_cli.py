"""tools/train_torch.py end to end on the synthetic dataset (--device cpu,
UpDown at tiny widths, 16 train images at batch 8: 2 iterations an epoch,
dropout 0):

* one epoch writes the JAX package's checkpoint contract: model /
  optimizer npz, infos (with the loader state, the best val score and the
  plateau state) and histories pickles, their ``-best`` copies and, with
  save_history_ckpt, the ``-<iter>`` ones;
* the JAX ``eval_split`` on the port's ``model-best.npz`` gives the same
  captions as tools/eval_torch.py on it;
* 2 + 2 steps resumed through --start_from give the loss history of 4
  straight steps (within 1e-5);
* each package resumes the other's checkpoint (model, optimizer.npz in
  the optax layout, infos, loader state) and its first step matches the
  other package's straight run (the loss within 1e-4);
* a val ``eval_split`` between two steps changes nothing the next step
  reads;
* ``--compute_dtype bfloat16`` trains XE then SCST with float32 masters:
  the ``model.npz`` it writes is float32 and the masters bit for bit, the
  JAX ``eval_split`` in float32 on it gives the port's float32 captions,
  and a JAX bf16 run's checkpoint (optimizer state too) resumes in the
  port;
* bert and m2transformer train an XE epoch and the JAX ``eval_split``
  decodes the port's checkpoint to tools/eval_torch.py's captions."""

import os
import pickle

import numpy as np
import pytest

from tests.util_synth import build_synthetic_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def ds(tmp_path_factory):
    return build_synthetic_dataset(str(tmp_path_factory.mktemp('synth_tcli')))


def _args(ds, ckpt, epochs, **kw):
    opts = dict(caption_model='updown', id='tr', checkpoint_path=ckpt,
                input_json=ds.input_json, input_label_h5=ds.input_label_h5,
                input_fc_dir=ds.input_fc_dir, input_att_dir=ds.input_att_dir,
                fc_feat_size=ds.fc_dim, att_feat_size=ds.att_dim,
                rnn_size=24, input_encoding_size=16, att_hid_size=8,
                batch_size=8, seq_per_img=5, max_length=6,
                max_epochs=epochs, save_checkpoint_every=2, language_eval=0,
                val_images_use=4, losses_log_every=1, drop_prob_lm=0.0,
                learning_rate=5e-3, num_data_threads=2, seed=3)
    opts.update(kw)
    args = []
    for k, v in opts.items():
        if v is True:
            args.append('--' + k)
        elif v is not None:
            args += ['--' + k, str(v)]
    return args


def _train_port(args):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'train_torch', os.path.join(REPO, 'tools', 'train_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(['--device', 'cpu'] + args)


def _train_jax(args):
    import captioning_tpu.utils.opts as jopts
    from tools.train import train
    train(jopts.parse_opt(args))


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f, encoding='latin-1')


def _losses(ckpt):
    hist = _load(os.path.join(ckpt, 'histories_tr.pkl'))['loss_history']
    return [hist[i] for i in sorted(hist)]


@pytest.fixture(scope='module')
def port_run(ds, tmp_path_factory):
    root = tmp_path_factory.mktemp('port_run')
    ckpt = str(root / 'ckpt')
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _train_port(_args(ds, ckpt, 1, save_history_ckpt=1,
                          reduce_on_plateau=True))
    finally:
        os.chdir(cwd)
    return root, ckpt


def test_one_epoch_writes_the_checkpoint_contract(port_run):
    _, ckpt = port_run
    names = set(os.listdir(ckpt))
    for stem in ('model%s.npz', 'optimizer%s.npz', 'infos_tr%s.pkl'):
        for append in ('', '-best', '-2'):
            assert stem % append in names, stem % append
    assert 'histories_tr.pkl' in names
    infos = _load(os.path.join(ckpt, 'infos_tr.pkl'))
    assert (infos['iter'], infos['epoch']) == (2, 1)
    assert infos['loader_state_dict'] is not None
    assert np.isfinite(infos['best_val_score'])
    assert infos['plateau_state_dict']['best'] is not None
    hist = _load(os.path.join(ckpt, 'histories_tr.pkl'))
    assert sorted(hist['loss_history']) == [1, 2]
    assert list(hist['val_result_history']) == [2]
    with np.load(os.path.join(ckpt, 'optimizer.npz')) as f:
        assert int(f['#1/#0/#0']) == 2          # adam's step count


def test_jax_eval_split_matches_eval_torch_on_the_port_checkpoint(
        port_run, ds, monkeypatch):
    import importlib.util

    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu.utils import eval_utils
    from captioning_tpu.utils.misc import load_pytree
    root, ckpt = port_run
    run = root / 'eval'
    run.mkdir()
    monkeypatch.chdir(run)
    spec = importlib.util.spec_from_file_location(
        'eval_torch', os.path.join(REPO, 'tools', 'eval_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(['--device', 'cpu', '--model',
              os.path.join(ckpt, 'model-best.npz'), '--infos_path',
              os.path.join(ckpt, 'infos_tr-best.pkl'), '--split', 'val',
              '--num_images', '4', '--language_eval', '0', '--force', '1',
              '--beam_size', '3', '--max_length', '6', '--id', 'tr'])
    got = _load(run / 'eval_results' / '.saved_pred_tr_val.pkl')[0]

    opt = _load(os.path.join(ckpt, 'infos_tr-best.pkl'))['opt']
    loader = DataLoader(opt)
    cap = jax_setup(opt, loader.get_vocab())
    variables = load_pytree(os.path.join(ckpt, 'model-best.npz'))
    kw = {'split': 'val', 'num_images': 4, 'language_eval': 0,
          'verbose': False, 'id': 'tr_jax', 'max_length': 6,
          'beam_size': 3, 'verbose_loss': 1}
    _, want, _ = eval_utils.eval_split(cap, variables, loader, kw)
    assert len(want) == 4
    assert [p['caption'] for p in got] == [p['caption'] for p in want]


def test_resumed_run_equals_the_straight_run(ds, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    straight, resumed = str(tmp_path / 'straight'), str(tmp_path / 'res')
    _train_port(_args(ds, straight, 2))
    _train_port(_args(ds, resumed, 1))
    _train_port(_args(ds, resumed, 2, start_from=resumed))
    want, got = _losses(straight), _losses(resumed)
    assert len(want) == 4
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize('first,then', [('jax', 'port'), ('port', 'jax')])
def test_each_package_resumes_the_others_checkpoint(ds, tmp_path,
                                                    monkeypatch, first,
                                                    then):
    """``first`` trains 4 steps, keeping its step-2 checkpoint (model,
    optimizer, infos with the loader state); ``then`` resumes from that
    checkpoint and its step 3 matches ``first``'s."""
    import shutil
    monkeypatch.chdir(tmp_path)
    run = {'jax': _train_jax, 'port': _train_port}
    straight, resumed = str(tmp_path / 'straight'), str(tmp_path / 'res')
    run[first](_args(ds, straight, 2, save_history_ckpt=1))
    os.makedirs(resumed)
    for name in ('model%s.npz', 'optimizer%s.npz', 'infos_tr%s.pkl'):
        shutil.copy(os.path.join(straight, name % '-2'),
                    os.path.join(resumed, name % ''))
    run[then](_args(ds, resumed, 2, start_from=resumed))
    want, got = _losses(straight), _losses(resumed)
    assert len(want) == 4 and len(got) == 2      # steps 3 and 4
    np.testing.assert_allclose(got[0], want[2], atol=1e-4, rtol=0)


def test_eval_split_between_steps_leaves_training_unchanged(ds, tmp_path,
                                                            monkeypatch):
    """A val ``eval_split`` (inference mode: teacher-forced loss and beam
    decode) between two XE steps changes nothing the next step reads: the
    losses, the parameters and the BatchNorm statistics equal a run
    without it, and the parameters still require grad."""
    import torch

    from captioning_tpu_torch.data.dataset import DataLoader
    from captioning_tpu_torch.models.api import setup
    from captioning_tpu_torch.modules.trainer import Trainer
    from captioning_tpu_torch.utils import eval_utils
    from tests.torch_port_util import train_opt
    from tests.util_synth import make_opt
    monkeypatch.chdir(tmp_path)
    opt = train_opt(make_opt(ds, 'updown', use_bn=2, max_length=6))
    loader = DataLoader(opt)
    opt.vocab_size = loader.vocab_size
    data = loader.get_batch('train')
    t = lambda k, dt: torch.as_tensor(np.asarray(data[k]), dtype=dt)
    batch = (t('fc_feats', torch.float32), t('att_feats', torch.float32),
             t('labels', torch.long), t('masks', torch.float32),
             t('att_masks', torch.float32))
    runs = []
    for with_eval in (False, True):
        cap = setup(opt, loader.get_vocab(), device='cpu').init_params(
            torch.Generator().manual_seed(0))
        tr = Trainer(cap, opt)
        losses = [float(tr.xe_step(*batch, 1e-2, 0.0,
                                   torch.Generator().manual_seed(1))['loss'])]
        if with_eval:
            eval_utils.eval_split(cap, loader, {
                'split': 'val', 'num_images': 4, 'language_eval': 0,
                'verbose': False, 'id': 'mid', 'beam_size': 2,
                'max_length': 6})
        losses.append(float(tr.xe_step(*batch, 1e-2, 0.0,
                                       torch.Generator().manual_seed(2))[
                                           'loss']))
        assert all(p.requires_grad for p in cap.module.parameters())
        runs.append((losses, {k: v.clone() for k, v in
                              cap.module.state_dict().items()}))
    (want, want_sd), (got, got_sd) = runs
    assert got == want
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k


@pytest.mark.parametrize('model', ['updown', 'stackatt', 'transformer',
                                   'aoa', 'bert', 'm2transformer'])
def test_profile_train_steps_on_the_cpu(model, monkeypatch):
    """``tools/profile_train.py``'s set-up (the one ``chip_smoke.py`` phase
    9 trains with) at tiny widths on the CPU: its config's options, one
    seeded batch of 10 x 5 captions of length 16, steps that lower the
    loss; its entry point refuses to run without a GPU."""
    import torch

    from captioning_tpu_torch.tools import profile_decode as pd
    from captioning_tpu_torch.tools import profile_train as pt
    monkeypatch.setattr(pd, 'V', 40)
    monkeypatch.setattr(pd, 'FEAT', 12)
    monkeypatch.setattr(pd, 'REGIONS', 5)
    tiny_transformer = dict(input_encoding_size=16, rnn_size=32,
                            num_layers=2, att_hid_size=8, N_enc=1, N_dec=1,
                            d_model=16, d_ff=32, num_att_heads=4)
    monkeypatch.setattr(pd, 'MODELS', {
        'transformer': tiny_transformer, 'bert': tiny_transformer,
        'm2transformer': tiny_transformer,
        'updown': dict(input_encoding_size=24, rnn_size=24, num_layers=2,
                       att_hid_size=8),
        'stackatt': dict(input_encoding_size=16, rnn_size=24, num_layers=1,
                         att_hid_size=8),
        'aoa': dict(input_encoding_size=16, rnn_size=24, num_layers=2,
                    att_hid_size=8, num_heads=4)})
    # a rate that moves the tiny model in a few steps (noam's first steps
    # barely move it)
    model_kw, opt_kw, ss_prob, _ = pt.TRAIN[model]
    monkeypatch.setitem(pt.TRAIN, model,
                        (model_kw, opt_kw, ss_prob, lambda it: 1e-2))
    tr, step, gen = pt.make_step(model, 'cpu')
    assert tr.captioner.module.cfg.drop_prob_lm == 0.5
    first_state = gen.get_state()
    first = float(step(1))
    for it in range(2, 6):
        step(it)
    gen.set_state(first_state)
    assert float(step(6)) < first
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='CUDA'):
        pt.main(['--model', model])


@pytest.mark.parametrize('model', ['updown', 'transformer'])
def test_profile_train_bf16_steps_on_the_cpu(model, monkeypatch):
    """``profile_train.make_step(..., dtype='bfloat16')`` at tiny widths:
    a bf16 captioner with float32 masters whose steps lower the loss, and
    ``--compute_dtype`` among the entry point's options."""
    import torch

    from captioning_tpu_torch.tools import profile_decode as pd
    from captioning_tpu_torch.tools import profile_train as pt
    monkeypatch.setattr(pd, 'V', 40)
    monkeypatch.setattr(pd, 'FEAT', 12)
    monkeypatch.setattr(pd, 'REGIONS', 5)
    monkeypatch.setattr(pd, 'MODELS', {
        'transformer': dict(input_encoding_size=16, rnn_size=32,
                            num_layers=2, att_hid_size=8, N_enc=1, N_dec=1,
                            d_model=16, d_ff=32, num_att_heads=4),
        'updown': dict(input_encoding_size=24, rnn_size=24, num_layers=2,
                       att_hid_size=8)})
    model_kw, opt_kw, ss_prob, _ = pt.TRAIN[model]
    monkeypatch.setitem(pt.TRAIN, model,
                        (model_kw, opt_kw, ss_prob, lambda it: 1e-2))
    tr, step, gen = pt.make_step(model, 'cpu', dtype='bfloat16')
    assert tr.captioner.cfg.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tr.named_params.values())
    first_state = gen.get_state()
    first = float(step(1))
    for it in range(2, 6):
        step(it)
    gen.set_state(first_state)
    assert float(step(6)) < first
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='CUDA'):
        pt.main(['--model', model, '--compute_dtype', 'bfloat16'])


@pytest.mark.parametrize('model,mode', [('updown', 'scst'),
                                        ('transformer', 'scst'),
                                        ('updown', 'struc'),
                                        ('aoa', 'scst')])
def test_profile_rl_steps_on_the_cpu(model, mode, monkeypatch):
    """``tools/profile_train.py``'s RL set-up (the one ``chip_smoke.py``
    phase 11 times) at tiny widths on the CPU: the SCST stage's options,
    references holding the model's greedy caption (so the rewards differ
    between samples), a df table built as prepro_ngrams builds it, and
    fused steps with finite losses; its entry point refuses to run
    without a GPU."""
    import torch

    from captioning_tpu_torch.ops.cider_device import DeviceCiderD
    from captioning_tpu_torch.tools import profile_decode as pd
    from captioning_tpu_torch.tools import profile_train as pt
    monkeypatch.setattr(pd, 'V', 40)
    monkeypatch.setattr(pd, 'FEAT', 12)
    monkeypatch.setattr(pd, 'REGIONS', 5)
    monkeypatch.setattr(pd, 'MODELS', {
        'transformer': dict(input_encoding_size=16, rnn_size=32,
                            num_layers=2, att_hid_size=8, N_enc=1, N_dec=1,
                            d_model=16, d_ff=32, num_att_heads=4),
        'updown': dict(input_encoding_size=24, rnn_size=24, num_layers=2,
                       att_hid_size=8),
        'aoa': dict(input_encoding_size=16, rnn_size=24, num_layers=2,
                    att_hid_size=8, num_heads=4)})
    df, ref_len = pt.corpus_df(images=50)
    assert ref_len == 50 and ('0',) in df
    assert max(len(g) for g in df) == 4
    scorer = DeviceCiderD(df, ref_len, device='cpu')
    tr, step, _, (fc, att, am, refs, ref_mask) = pt.make_rl_step(
        model, mode, 'cpu', B=2, scorer=scorer)
    assert tr.opt.train_sample_n == 5 and refs.shape == (2, 5, pt.L)
    assert tr.captioner.module.cfg.drop_prob_lm == 0.5
    rewards = []
    for it in range(2):
        out = step(it)
        assert torch.isfinite(out['loss'])
        rewards.append(out['reward'])
    if mode == 'struc':
        assert rewards[0].shape == (2, 5)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='CUDA'):
        pt.main(['--model', model, '--mode', mode])


@pytest.mark.parametrize('flag,value,error,match', [
    ('mesh_shape', 'data:1,model:2', ValueError, 'needs 2 ranks'),
    ('mesh_shape', 'data:2,model:2', ValueError, 'needs 4 ranks')])
def test_unported_training_raises(ds, tmp_path, monkeypatch, flag, value,
                                  error, match):
    """A mesh whose axes need more ranks than the run has raises before
    training; ``--device cuda`` without a GPU raises."""
    import importlib.util

    import torch

    import captioning_tpu_torch.utils.opts as popts
    monkeypatch.chdir(tmp_path)
    spec = importlib.util.spec_from_file_location(
        'train_torch', os.path.join(REPO, 'tools', 'train_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ckpt = str(tmp_path / 'ckpt')
    opt = popts.parse_opt(_args(ds, ckpt, 1, self_critical_after=0,
                                cached_tokens=ds.cached_tokens))
    setattr(opt, flag, value)
    with pytest.raises(error, match=match):
        mod.train(opt, device='cpu')
    if value == 'data:1,model:2':
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match='CUDA'):
            mod.main(_args(ds, ckpt, 1))


def _rl_args(ds, ckpt, epochs, **kw):
    """2 XE steps (epoch 0), then the SCST or structure stage: 2 samples
    an image, the CIDEr-D reward over the dataset's df pickle."""
    return _args(ds, ckpt, epochs, **dict(dict(
        cached_tokens=ds.cached_tokens, train_sample_n=2), **kw))


def _histories(ckpt):
    return _load(os.path.join(ckpt, 'histories_tr.pkl'))


@pytest.mark.parametrize('stage', ['scst', 'struc'])
def test_rl_stage_rewards_agree_across_scorers(ds, tmp_path, monkeypatch,
                                               stage):
    """2 XE steps, then 2 SCST (or structure, new_self_critical at weight
    0.5) steps through tools/train_torch.py: with the fused step on the
    on-device CIDEr-D (the default), with ``--on_device_cider 0`` and the
    native C++ scorer, and with the python scorer (the native library made
    unavailable), the loss history (the mean reward on SCST iterations)
    agrees within 1e-5: the three draw the same dropout and sampling
    noise, and the unfused grad step recomputes the decode's pass.  The
    checkpoint keeps the contract; the scorer in use is printed."""
    from captioning_tpu_torch.utils import cider_native, rewards
    monkeypatch.chdir(tmp_path)
    kw = ({'self_critical_after': 1} if stage == 'scst' else
          {'structure_after': 1, 'structure_loss_weight': 0.5,
           'structure_loss_type': 'new_self_critical'})
    runs = {}
    for scorer in ('device', 'native', 'python'):
        monkeypatch.setattr(rewards, 'CiderD_scorer', None)
        if scorer == 'python':
            monkeypatch.setattr(cider_native, 'NativeCiderD', None)
        ckpt = str(tmp_path / scorer)
        _train_port(_rl_args(ds, ckpt, 2, on_device_cider=(
            -1 if scorer == 'device' else 0), **kw))
        runs[scorer] = _histories(ckpt)['loss_history']
    assert sorted(runs['device']) == [1, 2, 3, 4]
    for scorer in ('native', 'python'):
        assert sorted(runs[scorer]) == [1, 2, 3, 4]
        np.testing.assert_allclose(
            [runs[scorer][i] for i in range(1, 5)],
            [runs['device'][i] for i in range(1, 5)], atol=1e-5, rtol=0,
            err_msg=scorer)
    infos = _load(os.path.join(str(tmp_path / 'device'), 'infos_tr.pkl'))
    assert (infos['iter'], infos['epoch']) == (4, 2)
    with np.load(os.path.join(str(tmp_path / 'device'),
                              'optimizer.npz')) as f:
        assert int(f['#1/#0/#0']) == 4
    # XE losses, then SCST's rewards (which can be negative)
    assert all(runs['device'][i] > 0 for i in (1, 2))


@pytest.mark.parametrize('optim,xe_route', [
    ('adam', 'train step xe: xe_step_graphed (run eagerly on the CPU)'),
    ('sgdmom', 'train step xe: eager (xe_step): torch.optim.SGD')])
def test_the_chosen_step_route_is_logged_once(ds, tmp_path, monkeypatch,
                                              capsys, optim, xe_route):
    """2 XE steps, then 2 SCST steps: each step kind's route (the graphed
    entry, which runs eagerly on the CPU, or the eager one with its
    reason) is printed once, on its first step."""
    monkeypatch.chdir(tmp_path)
    _train_port(_rl_args(ds, str(tmp_path / 'ckpt'), 2,
                         self_critical_after=1, optim=optim))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('train step ')]
    assert len(lines) == 2
    assert lines[0].startswith(xe_route)
    assert lines[1].startswith('train step sc_fused: ')
    assert ('sc_fused_step_graphed' in lines[1]) == (optim == 'adam')
    assert sorted(_histories(str(tmp_path / 'ckpt'))['loss_history']) == [
        1, 2, 3, 4]


def _aoa_args(ds, ckpt, epochs, cfg, **kw):
    """``configs/<cfg>`` at tiny widths through --set_cfgs (rnn 32 in 4
    heads, word embedding 16); the data, schedule and checkpoint flags of
    ``_args``, explicit flags taking precedence over the YAML."""
    args = _args(ds, ckpt, epochs, caption_model=None, rnn_size=None,
                 input_encoding_size=None, att_hid_size=None, **kw)
    return args + ['--cfg', os.path.join(REPO, 'configs', cfg),
                   '--set_cfgs', 'rnn_size', '32', 'input_encoding_size',
                   '16', 'num_heads', '4']


def test_aoa_xe_then_scst_through_the_configs(ds, tmp_path, monkeypatch):
    """AoANet through ``configs/aoa.yml`` (XE with label smoothing 0.2),
    then ``configs/aoa_sc.yml`` resumed from the XE checkpoint (SCST, 2
    samples an image); the SCST checkpoint's ``model.npz`` decodes to the
    same captions in the JAX ``eval_split`` as in tools/eval_torch.py."""
    import importlib.util

    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu.utils import eval_utils
    from captioning_tpu.utils.misc import load_pytree
    monkeypatch.chdir(tmp_path)
    xe, sc = str(tmp_path / 'xe'), str(tmp_path / 'sc')
    _train_port(_aoa_args(ds, xe, 1, 'aoa.yml'))
    infos = _load(os.path.join(xe, 'infos_tr.pkl'))
    assert infos['opt'].caption_model == 'aoa'
    assert infos['opt'].label_smoothing == 0.2
    assert (infos['opt'].rnn_size, infos['opt'].num_heads) == (32, 4)
    _train_port(_aoa_args(ds, sc, 2, 'aoa_sc.yml', start_from=xe,
                          cached_tokens=ds.cached_tokens, train_sample_n=2))
    infos = _load(os.path.join(sc, 'infos_tr.pkl'))
    assert (infos['iter'], infos['epoch']) == (4, 2)
    assert infos['opt'].self_critical_after == 0
    hist = _histories(sc)['loss_history']
    assert sorted(hist) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for v in hist.values())

    run = tmp_path / 'eval'
    run.mkdir()
    monkeypatch.chdir(run)
    spec = importlib.util.spec_from_file_location(
        'eval_torch', os.path.join(REPO, 'tools', 'eval_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(['--device', 'cpu', '--model', os.path.join(sc, 'model.npz'),
              '--infos_path', os.path.join(sc, 'infos_tr.pkl'), '--split',
              'val', '--num_images', '4', '--language_eval', '0',
              '--force', '1', '--beam_size', '3', '--max_length', '6',
              '--id', 'tr'])
    got = _load(run / 'eval_results' / '.saved_pred_tr_val.pkl')[0]
    opt = infos['opt']
    loader = DataLoader(opt)
    cap = jax_setup(opt, loader.get_vocab())
    variables = load_pytree(os.path.join(sc, 'model.npz'))
    _, want, _ = eval_utils.eval_split(cap, variables, loader, {
        'split': 'val', 'num_images': 4, 'language_eval': 0,
        'verbose': False, 'id': 'tr_jax', 'max_length': 6, 'beam_size': 3})
    assert len(want) == 4
    assert [p['caption'] for p in got] == [p['caption'] for p in want]


@pytest.mark.parametrize('model', ['bert', 'm2transformer'])
def test_bert_and_m2_train_then_decode_in_both_packages(ds, tmp_path,
                                                        monkeypatch, model):
    """One XE epoch of ``--caption_model bert|m2transformer`` at the
    transformer's option names cut by --set_cfgs (2 + 2 layers, d_model 16
    in 4 heads, d_ff 32); the JAX ``eval_split`` on the port's
    ``model.npz`` gives tools/eval_torch.py's beam-3 captions."""
    import importlib.util

    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu.utils import eval_utils
    from captioning_tpu.utils.misc import load_pytree
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / 'ckpt')
    _train_port(_args(ds, ckpt, 1, caption_model=model, rnn_size=None,
                      input_encoding_size=None, att_hid_size=None) +
                ['--set_cfgs', 'N_enc', '2', 'N_dec', '2', 'd_model', '16',
                 'd_ff', '32', 'num_att_heads', '4'])
    infos = _load(os.path.join(ckpt, 'infos_tr.pkl'))
    assert infos['opt'].caption_model == model
    assert (infos['opt'].N_enc, infos['opt'].d_model) == (2, 16)
    hist = _losses(ckpt)
    assert len(hist) == 2 and all(np.isfinite(hist))

    run = tmp_path / 'eval'
    run.mkdir()
    monkeypatch.chdir(run)
    spec = importlib.util.spec_from_file_location(
        'eval_torch', os.path.join(REPO, 'tools', 'eval_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(['--device', 'cpu', '--model', os.path.join(ckpt, 'model.npz'),
              '--infos_path', os.path.join(ckpt, 'infos_tr.pkl'), '--split',
              'val', '--num_images', '4', '--language_eval', '0',
              '--force', '1', '--beam_size', '3', '--max_length', '6',
              '--id', 'tr'])
    got = _load(run / 'eval_results' / '.saved_pred_tr_val.pkl')[0]
    opt = infos['opt']
    loader = DataLoader(opt)
    cap = jax_setup(opt, loader.get_vocab())
    variables = load_pytree(os.path.join(ckpt, 'model.npz'))
    _, want, _ = eval_utils.eval_split(cap, variables, loader, {
        'split': 'val', 'num_images': 4, 'language_eval': 0,
        'verbose': False, 'id': 'tr_jax', 'max_length': 6, 'beam_size': 3})
    assert len(want) == 4
    assert [p['caption'] for p in got] == [p['caption'] for p in want]


def test_default_caption_model_trains(ds, tmp_path, monkeypatch):
    """Without --caption_model the opts default, show_tell, trains: one
    step (16 images at batch 16) writes its checkpoint."""
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / 'ckpt')
    _train_port(_args(ds, ckpt, 1, caption_model=None, batch_size=16,
                      save_checkpoint_every=1))
    infos = _load(os.path.join(ckpt, 'infos_tr.pkl'))
    assert infos['opt'].caption_model == 'show_tell'
    assert infos['iter'] == 1
    hist = _histories(ckpt)['loss_history']
    assert sorted(hist) == [1] and np.isfinite(hist[1])


def test_ppo_stage_runs(ds, tmp_path, monkeypatch):
    """PPO through the loop: the old policy loaded from
    ``--ppo_old_model_path`` (an XE checkpoint), the structure stage's
    fused steps; the old model's file is left as it was."""
    monkeypatch.chdir(tmp_path)
    xe = str(tmp_path / 'xe')
    _train_port(_rl_args(ds, xe, 1))
    before = open(os.path.join(xe, 'model.npz'), 'rb').read()
    ckpt = str(tmp_path / 'ppo')
    _train_port(_rl_args(ds, ckpt, 2, structure_after=1, use_ppo=1,
                         ppo_old_model_path=os.path.join(xe, 'model.npz')))
    hist = _histories(ckpt)['loss_history']
    assert sorted(hist) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for v in hist.values())
    assert open(os.path.join(xe, 'model.npz'), 'rb').read() == before


def test_rl_stage_resumes_across_packages(ds, tmp_path, monkeypatch):
    """tools/train.py trains the XE epoch; tools/train_torch.py resumes its
    checkpoint into the SCST stage; tools/train.py resumes the port's SCST
    checkpoint and goes on with SCST.  Each resume continues the iteration
    count, the optimizer's step and the loss history (a checkpoint every
    iteration)."""
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / 'ckpt')
    iters = []
    for run, epochs in ((_train_jax, 1), (_train_port, 2), (_train_jax, 3)):
        run(_rl_args(ds, ckpt, epochs, self_critical_after=1,
                     save_checkpoint_every=1,
                     start_from=ckpt if iters else None))
        infos = _load(os.path.join(ckpt, 'infos_tr.pkl'))
        assert infos['epoch'] == epochs
        iters.append(infos['iter'])
        with np.load(os.path.join(ckpt, 'optimizer.npz')) as f:
            assert int(f['#1/#0/#0']) == infos['iter']
    assert iters[0] < iters[1] < iters[2]
    hist = _histories(ckpt)['loss_history']
    assert sorted(hist) == list(range(1, iters[2] + 1))
    assert all(np.isfinite(v) for v in hist.values())


def test_bf16_xe_then_scst_saves_the_float32_masters(ds, tmp_path,
                                                      monkeypatch):
    """One XE epoch, then one SCST epoch (the fused step, the CIDEr-D
    reward on the device), at --compute_dtype bfloat16: the checkpoint
    holds what ``Captioner.jax_variables`` held at the save, the float32
    masters (values a bf16 copy cannot hold), which a bf16 captioner loads
    and writes back bit for bit."""
    import torch

    from captioning_tpu_torch.models import api
    from captioning_tpu_torch.models.api import setup
    from captioning_tpu_torch.utils.misc import _flatten_tree, load_pytree
    saved = []
    jax_variables = api.Captioner.jax_variables

    def record(self):
        assert all(p.dtype == torch.float32
                   for p in self.module.parameters())
        out = jax_variables(self)
        saved.append(_flatten_tree(out))
        return out

    monkeypatch.setattr(api.Captioner, 'jax_variables', record)
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / 'bf16')
    _train_port(_rl_args(ds, ckpt, 2, compute_dtype='bfloat16',
                         self_critical_after=1))
    hist = _histories(ckpt)
    assert sorted(hist['loss_history']) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for v in hist['loss_history'].values())
    infos = _load(os.path.join(ckpt, 'infos_tr.pkl'))
    assert infos['opt'].compute_dtype == 'bfloat16'
    got = _flatten_tree(load_pytree(os.path.join(ckpt, 'model.npz')))
    assert sorted(got) == sorted(saved[-1])
    below_bf16 = 0
    for key, value in got.items():
        assert value.dtype == np.float32, key
        np.testing.assert_array_equal(value, saved[-1][key], err_msg=key)
        bits = value.view(np.uint32)
        below_bf16 += int(np.count_nonzero(bits & 0xFFFF))
    assert below_bf16 > 0.9 * sum(v.size for v in got.values())
    monkeypatch.undo()
    cap = setup(infos['opt'], infos['vocab'], device='cpu').load_params(
        os.path.join(ckpt, 'model.npz'))
    assert cap.cfg.dtype == torch.bfloat16
    back = _flatten_tree(cap.jax_variables())
    for key, value in got.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_jax_eval_reads_a_bf16_trained_checkpoint(ds, tmp_path, monkeypatch):
    """A bf16 run's ``model.npz`` decoded in float32 (its infos' compute
    dtype set to float32) by the JAX ``eval_split`` and by
    tools/eval_torch.py: the same captions."""
    import importlib.util

    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu.utils import eval_utils
    from captioning_tpu.utils.misc import load_pytree
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / 'bf16')
    _train_port(_args(ds, ckpt, 1, compute_dtype='bfloat16'))
    infos = _load(os.path.join(ckpt, 'infos_tr.pkl'))
    infos['opt'].compute_dtype = 'float32'
    infos_path = os.path.join(ckpt, 'infos_tr-f32.pkl')
    with open(infos_path, 'wb') as f:
        pickle.dump(infos, f)
    spec = importlib.util.spec_from_file_location(
        'eval_torch', os.path.join(REPO, 'tools', 'eval_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(['--device', 'cpu', '--model', os.path.join(ckpt, 'model.npz'),
              '--infos_path', infos_path, '--split', 'val',
              '--num_images', '4', '--language_eval', '0', '--force', '1',
              '--beam_size', '3', '--max_length', '6', '--id', 'tr'])
    got = _load(tmp_path / 'eval_results' / '.saved_pred_tr_val.pkl')[0]
    loader = DataLoader(infos['opt'])
    cap = jax_setup(infos['opt'], loader.get_vocab())
    variables = load_pytree(os.path.join(ckpt, 'model.npz'))
    kw = {'split': 'val', 'num_images': 4, 'language_eval': 0,
          'verbose': False, 'id': 'tr_jax', 'max_length': 6,
          'beam_size': 3, 'verbose_loss': 1}
    _, want, _ = eval_utils.eval_split(cap, variables, loader, kw)
    assert len(want) == 4
    assert [p['caption'] for p in got] == [p['caption'] for p in want]


def test_port_resumes_a_jax_bf16_run(ds, tmp_path, monkeypatch):
    """A JAX bf16 run's step-2 checkpoint (model, optimizer.npz in the
    optax layout, infos) resumes in the port at bf16: adam's step count
    carries on, and the port's step 3 is the JAX run's within 1e-2."""
    import shutil
    monkeypatch.chdir(tmp_path)
    straight, resumed = str(tmp_path / 'straight'), str(tmp_path / 'res')
    _train_jax(_args(ds, straight, 2, save_history_ckpt=1,
                     compute_dtype='bfloat16'))
    os.makedirs(resumed)
    for name in ('model%s.npz', 'optimizer%s.npz', 'infos_tr%s.pkl'):
        shutil.copy(os.path.join(straight, name % '-2'),
                    os.path.join(resumed, name % ''))
    _train_port(_args(ds, resumed, 2, start_from=resumed,
                      compute_dtype='bfloat16'))
    want, got = _losses(straight), _losses(resumed)
    assert len(want) == 4 and len(got) == 2      # steps 3 and 4
    np.testing.assert_allclose(got, want[2:], rtol=1e-2)
    with np.load(os.path.join(resumed, 'optimizer.npz')) as f:
        assert int(f['#1/#0/#0']) == 4


def _cli(script, args, cwd):
    """``tools/<script> --device cpu <args>`` as a process in ``cwd``."""
    import subprocess
    import sys
    os.makedirs(cwd, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, 'tools', script),
         '--device', 'cpu'] + args, cwd=cwd, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)        # its ranks die with it


@pytest.fixture(scope='module')
def two_ranks(ds, tmp_path_factory):
    """(one process's checkpoint dir and output, the 2-rank run's): batch
    7 (4 images on rank 0, 3 on rank 1), 2 steps and one val eval;
    tools/train_torch.py beside tools/train_pl_torch.py ``--mesh_shape
    data:2``, which starts two tools/train_torch.py ranks
    (``--dist_coordinator``, gloo).  A hang fails at the timeout."""
    import signal
    root = tmp_path_factory.mktemp('two_ranks')
    runs = [(str(root / name / 'ckpt'), _cli(script, _args(
        ds, str(root / name / 'ckpt'), 1, batch_size=7) + extra,
        str(root / name))) for name, script, extra in (
            ('one', 'train_torch.py', []),
            ('two', 'train_pl_torch.py', ['--mesh_shape', 'data:2']))]
    out = []
    try:
        for ckpt, p in runs:
            out.append((ckpt, p.communicate(timeout=240)[0]))
    finally:
        for _, p in runs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    for (_, p), (_, log) in zip(runs, out):
        assert p.returncode == 0, log[-3000:]
    return out


def test_two_rank_run_equals_one_process(two_ranks):
    """The loss history within rtol 2e-4 / atol 2e-5 (the JAX 2-process
    test's bound), the val loss too, the val predictions equal; rank 0
    alone printed the steps and wrote the checkpoints, the histories and
    tensorboard."""
    (one, log1), (two, log2) = two_ranks
    assert 'distributed: rank 1 of 2, backend gloo, device cpu' in log2
    assert 'train step xe: eager (xe_step): data-parallel (world > 1)' \
        in log2
    for line in ('model saved to', 'iter 0 (epoch 0)', 'iter 1 (epoch 0)'):
        assert log2.count(line) == log1.count(line) > 0, line
    h1, h2 = _histories(one), _histories(two)
    assert sorted(h1['loss_history']) == sorted(h2['loss_history']) == [1, 2]
    for it in h1['loss_history']:
        np.testing.assert_allclose(h2['loss_history'][it],
                                   h1['loss_history'][it], rtol=2e-4,
                                   atol=2e-5)
    v1, v2 = h1['val_result_history'], h2['val_result_history']
    assert sorted(v1) == sorted(v2) == [2]
    np.testing.assert_allclose(v2[2]['loss'], v1[2]['loss'], rtol=2e-4,
                               atol=2e-5)
    assert [(p['image_id'], p['caption']) for p in v2[2]['predictions']] \
        == [(p['image_id'], p['caption']) for p in v1[2]['predictions']]
    names = os.listdir(two)
    assert {'model.npz', 'optimizer.npz', 'infos_tr.pkl',
            'histories_tr.pkl'} <= set(names)
    assert sum(n.startswith('events.out.tfevents') for n in names) == 1


def test_train_pl_torch_evaluates(ds, two_ranks, tmp_path, monkeypatch):
    """``EVALUATE=1`` tools/train_pl_torch.py evaluates the 2-rank run's
    ``model-best.npz`` on the test split through tools/eval_torch.py."""
    import importlib.util
    monkeypatch.chdir(tmp_path)
    spec = importlib.util.spec_from_file_location(
        'train_pl_torch', os.path.join(REPO, 'tools', 'train_pl_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ckpt = two_ranks[1][0]
    assert {'model-best.npz', 'infos_tr-best.pkl'} <= set(os.listdir(ckpt))
    monkeypatch.setenv('EVALUATE', '1')
    mod.main(['--device', 'cpu'] + _args(ds, ckpt, 1, beam_size=2))
    preds, _ = _load(os.path.join('eval_results', '.saved_pred_tr_test.pkl'))
    assert len(preds) == 4 and all(p['caption'] for p in preds)
