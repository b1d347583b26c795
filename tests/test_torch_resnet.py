"""The port's ResNet feature extractor (``models/resnet.py``), raw-image
loader (``data/dataloaderraw.py``), ``tools/eval_torch.py --image_folder``
and ``scripts/prepro_feats_torch.py`` against the JAX package's, float32
on the CPU.  One seeded random torchvision-format ``state_dict`` a
network, saved with ``torch.save`` and read by both packages: the
features of resnet50 (bottleneck, the stride on conv1) and resnet18
(basic block) at image sizes where the ceil-mode maxpool takes a partial
window and layer4's side is no multiple of 14, within 1e-4 of the largest
magnitude; the maxpool alone at every size from 3 to 12; the weight
bridge; the loader's listing (the subfolder quirk, ``coco_json``), wrap,
``infos`` and one batch; the two scripts on two images."""

import json
import os

import numpy as np
import pytest
import torch

from captioning_tpu_torch.models import resnet as pr
from tests.torch_port_util import jax_tool_main, port_cli_beside

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    """<root>/data/imagenet_weights/<arch>.pth for resnet50 and resnet18,
    seeded."""
    root = tmp_path_factory.mktemp('resnet')
    wdir = root / 'data' / 'imagenet_weights'
    wdir.mkdir(parents=True)
    for seed, arch in enumerate(('resnet50', 'resnet18')):
        torch.save(pr.random_state_dict(arch,
                                        torch.Generator().manual_seed(seed)),
                   wdir / (arch + '.pth'))
    return root


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= REL * scale, \
        np.abs(got - want).max() / scale


def _image(h, w, seed):
    return np.random.RandomState(seed).rand(h, w, 3).astype('float32')


# (arch, image H x W): conv1 gives 42 x 37 (the even side ends its
# maxpool on a partial window), layer4 3 x 3 (fewer sides than the 14
# bins); resnet18: conv1 33 x 48, layer4 2 x 3
@pytest.mark.parametrize('arch,hw', [('resnet50', (83, 73)),
                                     ('resnet18', (66, 95))])
def test_features_match_jax(weights, arch, hw):
    import jax

    from captioning_tpu.models import resnet as jr
    path = str(weights / 'data' / 'imagenet_weights' / (arch + '.pth'))
    img = _image(*hw, seed=1)
    jfc, jatt = jax.jit(lambda x: jr.resnet_features(
        jr.load_torch_resnet(path), x, arch))(img)
    fc, att = pr.resnet_features(pr.load_resnet(path, arch, 'cpu'), img)
    width = 2048 if arch == 'resnet50' else 512
    assert fc.shape == (width,) and att.shape == (14, 14, width)
    _close(fc, jfc)
    _close(att, jatt)


def test_ceil_maxpool_matches_jax_at_every_size():
    import jax.numpy as jnp

    from captioning_tpu.models import resnet as jr
    x = np.random.RandomState(2).randn(1, 12, 12, 3).astype('float32')
    for h in range(3, 13):
        for w in (3, 4, 7, 12):
            want = np.asarray(jr._maxpool_ceil(jnp.asarray(x[:, :h, :w])))
            got = torch.nn.functional.max_pool2d(
                torch.from_numpy(x[:, :h, :w]).permute(0, 3, 1, 2), 3, 2, 0,
                ceil_mode=True).permute(0, 2, 3, 1)
            np.testing.assert_array_equal(got.numpy(), want)


def test_weight_bridge_round_trip(weights):
    from captioning_tpu.models import resnet as jr
    path = weights / 'data' / 'imagenet_weights' / 'resnet18.pth'
    want = torch.load(path)
    params = jr.load_torch_resnet(str(path))
    got = pr.state_dict_from_jax_resnet(params, 'resnet18')
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # an old torchvision file has no num_batches_tracked
    old = {k: v for k, v in params.items()
           if not k.endswith('num_batches_tracked')}
    pr.ResNet('resnet18').load_state_dict(
        pr.state_dict_from_jax_resnet(old, 'resnet18'))
    with pytest.raises(KeyError, match='stray'):
        pr.state_dict_from_jax_resnet(dict(params, extra=np.zeros(1)),
                                      'resnet18')
    missing = dict(params)
    del missing['layer2.0.conv1.weight']
    with pytest.raises(KeyError, match='layer2.0.conv1.weight'):
        pr.state_dict_from_jax_resnet(missing, 'resnet18')


def _write_images(folder, names, hw=(40, 52)):
    from PIL import Image
    for i, name in enumerate(names):
        path = folder / name
        path.parent.mkdir(parents=True, exist_ok=True)
        arr = (_image(*hw, seed=10 + i) * 255).astype('uint8')
        Image.fromarray(arr).save(path)


def _loaders(weights, opt):
    from captioning_tpu.data.dataloaderraw import DataLoaderRaw as JaxRaw

    from captioning_tpu_torch.data.dataloaderraw import DataLoaderRaw
    cwd = os.getcwd()
    os.chdir(weights)
    try:
        return JaxRaw(opt), DataLoaderRaw(dict(opt, device='cpu'))
    finally:
        os.chdir(cwd)


def test_loader_listing_matches_jax(weights, tmp_path):
    """The folder walk keeps the reference quirk: a subfolder's file is
    listed under the top folder's path; the ``coco_json`` list reads
    file_name and id."""
    folder = tmp_path / 'imgs'
    _write_images(folder, ['a.jpg', 'b.png', 'sub/c.jpg'])
    (folder / 'notes.txt').write_text('not an image')
    opt = {'folder_path': str(folder), 'batch_size': 2,
           'cnn_model': 'resnet18'}
    jl, pl = _loaders(weights, opt)
    assert pl.files == jl.files and pl.ids == jl.ids
    assert sorted(pl.files) == [str(folder / n)
                                for n in ('a.jpg', 'b.png', 'c.jpg')]
    assert pl.ids == ['1', '2', '3'] and pl.N == 3
    coco = tmp_path / 'list.json'
    coco.write_text(json.dumps({'images': [
        {'file_name': 'b.png', 'id': 7}, {'file_name': 'sub/c.jpg',
                                          'id': 9}]}))
    jl, pl = _loaders(weights, dict(opt, coco_json=str(coco)))
    assert pl.files == jl.files == [str(folder / 'b.png'),
                                    str(folder / 'sub' / 'c.jpg')]
    assert pl.ids == jl.ids == [7, 9]
    with pytest.raises(FileNotFoundError, match='resnet34.pth'):
        _loaders(weights, dict(opt, cnn_model='resnet34'))


def test_loader_batches_match_jax(weights, tmp_path):
    """Two batches of 2 over 3 images: the features, masks, infos and
    bounds of the first, the wrap of the second."""
    folder = tmp_path / 'imgs'
    _write_images(folder, ['x0.png', 'x1.png', 'x2.png'])
    jl, pl = _loaders(weights, {'folder_path': str(folder), 'batch_size': 2,
                                'cnn_model': 'resnet50'})
    want, got = jl.get_batch('test'), pl.get_batch('test')
    for k in ('fc_feats', 'att_feats'):
        assert got[k].shape == want[k].shape
        _close(got[k], want[k])
    np.testing.assert_array_equal(got['att_masks'], want['att_masks'])
    for k in ('labels', 'masks', 'gts', 'bounds', 'infos'):
        assert got[k] == want[k], k
    assert got['att_feats'].shape == (2, 196, 2048)
    jl.get_batch('test')
    got = pl.get_batch('test')
    assert got['bounds'] == {'it_pos_now': 1, 'it_max': 3, 'wrapped': True}
    assert [i['id'] for i in got['infos']] == [pl.ids[2], pl.ids[0]]
    assert pl.iterator == jl.iterator == 1


def test_eval_image_folder_matches_jax(weights, tmp_path, monkeypatch):
    """A tiny transformer on 2048-wide features captions a folder of two
    images through resnet50: the port's CLI and tools/eval.py give the same
    captions."""
    import jax

    from captioning_tpu.models import setup
    from captioning_tpu.utils import misc
    from tests.torch_port_util import tiny_opt, tiny_vocab

    opt = tiny_opt(fc_feat_size=2048, att_feat_size=2048, id='raw')
    vocab = tiny_vocab()
    variables = setup(opt, vocab).init_params(jax.random.PRNGKey(0),
                                              att_len=5)
    misc.save_pytree(variables, str(tmp_path / 'model.npz'))
    with open(tmp_path / 'infos_raw.pkl', 'wb') as f:
        misc.pickle_dump({'opt': opt, 'vocab': vocab}, f)
    _write_images(tmp_path / 'imgs', ['p.jpg', 'q.png'])
    args = ['--model', str(tmp_path / 'model.npz'), '--infos_path',
            str(tmp_path / 'infos_raw.pkl'), '--image_folder',
            str(tmp_path / 'imgs'), '--cnn_model', 'resnet50',
            '--batch_size', '2', '--beam_size', '2', '--language_eval', '0',
            '--force', '1', '--dump_images', '0', '--max_length', '6']
    for name in ('jax', 'port'):
        (tmp_path / name / 'data').mkdir(parents=True)
        os.symlink(weights / 'data' / 'imagenet_weights',
                   tmp_path / name / 'data' / 'imagenet_weights')
    monkeypatch.chdir(tmp_path / 'jax')
    port_cli_beside(
        [os.path.join(REPO, 'tools', 'eval_torch.py'), '--device', 'cpu']
        + args, tmp_path / 'port',
        lambda: jax_tool_main(os.path.join(REPO, 'tools', 'eval.py'), args,
                              monkeypatch))
    out = {}
    for name in ('jax', 'port'):
        with open(tmp_path / name / 'vis' / 'vis.json') as f:
            out[name] = json.load(f)
    got, want = out['port'], out['jax']
    assert [p['image_id'] for p in got] == ['1', '2']
    assert [(p['image_id'], p['caption']) for p in got] == \
        [(p['image_id'], p['caption']) for p in want]
    for key in ('entropy', 'perplexity'):
        np.testing.assert_allclose([p[key] for p in got],
                                   [p[key] for p in want], atol=1e-4)


def test_prepro_feats_matches_jax(weights, tmp_path):
    _write_images(tmp_path / 'images' / 'val2014', ['m.jpg', 'n.jpg'],
                  hw=(47, 38))
    listing = tmp_path / 'dataset.json'
    listing.write_text(json.dumps({'images': [
        {'filepath': 'val2014', 'filename': 'm.jpg', 'cocoid': 11},
        {'filepath': 'val2014', 'filename': 'n.jpg', 'cocoid': 12}]}))
    params = {'input_json': str(listing), 'images_root':
              str(tmp_path / 'images'), 'model': 'resnet18', 'model_root':
              str(weights / 'data' / 'imagenet_weights'), 'att_size': 14}
    argv = [os.path.join(REPO, 'scripts', 'prepro_feats_torch.py'),
            '--device', 'cpu', '--output_dir', str(tmp_path / 'port' /
                                                   'feats')]
    for k in ('input_json', 'images_root', 'model', 'model_root'):
        argv += ['--' + k, params[k]]
    (tmp_path / 'port').mkdir()

    def jax_side():
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            'prepro_feats', os.path.join(REPO, 'scripts', 'prepro_feats.py'))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main(dict(params, output_dir=str(tmp_path / 'jax' / 'feats')))
    port_cli_beside(argv, tmp_path / 'port', jax_side)
    for cocoid in (11, 12):
        want_fc = np.load(tmp_path / 'jax' / 'feats_fc'
                          / ('%d.npy' % cocoid))
        got_fc = np.load(tmp_path / 'port' / 'feats_fc'
                         / ('%d.npy' % cocoid))
        assert got_fc.shape == (512,)
        _close(got_fc, want_fc)
        want_att = np.load(tmp_path / 'jax' / 'feats_att'
                           / ('%d.npz' % cocoid))['feat']
        got_att = np.load(tmp_path / 'port' / 'feats_att'
                          / ('%d.npz' % cocoid))['feat']
        assert got_att.shape == (14, 14, 512)
        _close(got_att, want_att)


def test_cuda_without_gpu_raises(weights, monkeypatch, tmp_path):
    from captioning_tpu_torch.data.dataloaderraw import DataLoaderRaw
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(weights)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        DataLoaderRaw({'folder_path': str(tmp_path),
                       'cnn_model': 'resnet18'})
