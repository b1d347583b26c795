"""The upstream checkpoint import on the port: its copy of the converter
(``captioning_tpu_torch/utils/torch_convert.py``) and
``tools/import_torch_checkpoint_torch.py`` against the JAX package's
originals, on the CPU.

No upstream ``model.pth`` comes from outside the repository, so each test
builds a synthetic upstream ``state_dict`` for a ``caption_model`` key, at
small widths, by inverting the JAX converter over a JAX-initialised model
(``tests/torch_import_util.py``: the names it reads, each holding the leaf
it lands in, transposed where the converter transposes).
For every key the converter handles:

* the port's copy and the original give the same tree from it, which is
  the JAX init's (same paths, equal arrays);
* the two tools, each run in-process on one ``torch.save``d file, write
  equal ``model.npz`` arrays and infos (``loader_state_dict`` None);
* for the transformer, UpDown and Att2in2 the run directory decodes to the
  same greedy and beam-3 tokens in the port (``Captioner.load_params``,
  the kernels' twins) and in the JAX package.

``bert`` and ``m2transformer`` raise ``ValueError('unsupported
caption_model ...')`` in both."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_import_util import upstream_state_dict
from tests.torch_port_util import (M, V, inputs, jax_tool_main, tiny_aoa_opt,
                                   tiny_opt, tiny_rnn_opt, tiny_vocab)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ['transformer', 'aoa', 'att2in', 'att2in2', 'att2all2', 'updown',
        'topdown', 'stackatt', 'denseatt', 'adaatt', 'adaattmo', 'newfc',
        'language_model', 'fc', 'show_tell']
DECODED = ['transformer', 'updown', 'att2in2']


def _opt(key):
    if key in ('transformer', 'bert', 'm2transformer'):
        return tiny_opt(caption_model=key, N_enc=2, N_dec=2)
    if key == 'aoa':
        return tiny_aoa_opt()
    return tiny_rnn_opt(key)


def _flat(tree):
    from captioning_tpu.utils.misc import _flatten_tree
    return _flatten_tree(jax.tree.map(np.asarray, tree))


_SIDES = {}


def sides(key):
    """(opt, JAX captioner, JAX init variables, upstream state_dict)."""
    if key not in _SIDES:
        from captioning_tpu.models import setup as jax_setup
        from captioning_tpu.models.harness import config_from_opt
        from captioning_tpu.utils.torch_convert import convert_state_dict
        opt = _opt(key)
        jcap = jax_setup(opt, tiny_vocab())
        variables = jax.tree.map(np.asarray, jcap.init_params(
            jax.random.PRNGKey(0), att_len=M))
        sd = upstream_state_dict(convert_state_dict,
                                 config_from_opt(opt, V), _flat(variables),
                                 _flat)
        _SIDES[key] = (opt, jcap, variables, sd)
    return _SIDES[key]


@pytest.mark.parametrize('key', KEYS)
def test_converted_trees_equal(key):
    from captioning_tpu.models.harness import config_from_opt as jcfg
    from captioning_tpu.utils.torch_convert import convert_state_dict as jconv
    from captioning_tpu_torch.models.config import config_from_opt as pcfg
    from captioning_tpu_torch.utils.torch_convert import convert_state_dict
    opt, _, variables, sd = sides(key)
    got = _flat(convert_state_dict(sd, pcfg(opt, V)))
    want = _flat(jconv(sd, jcfg(opt, V)))
    init = _flat(variables)
    assert sorted(got) == sorted(want) == sorted(init)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
        np.testing.assert_array_equal(got[path], init[path], err_msg=path)


@pytest.mark.parametrize('key', ['bert', 'm2transformer'])
def test_unconverted_keys_raise(key):
    from captioning_tpu.models.harness import config_from_opt as jcfg
    from captioning_tpu.utils.torch_convert import convert_state_dict as jconv
    from captioning_tpu_torch.models.config import config_from_opt as pcfg
    from captioning_tpu_torch.utils.torch_convert import convert_state_dict
    opt = _opt(key)
    for convert, cfg in ((convert_state_dict, pcfg(opt, V)),
                         (jconv, jcfg(opt, V))):
        # the shared embeds are read before the key's branch raises
        sd = {}
        with pytest.raises(ValueError, match='unsupported caption_model '
                           + key):
            while True:
                try:
                    convert(sd, cfg)
                except KeyError as e:
                    sd[e.args[0]] = np.zeros((1, 1), np.float32)


def _tool(tmp_path, monkeypatch, key):
    """Run both tools on one saved checkpoint: (the port's run directory,
    the JAX tool's)."""
    import importlib.util
    opt, _, _, sd = sides(key)
    src = tmp_path / 'upstream'
    src.mkdir()
    torch.save(sd, str(src / 'model.pth'))
    with open(src / 'infos_up.pkl', 'wb') as f:
        pickle.dump({'opt': opt, 'vocab': tiny_vocab(),
                     'loader_state_dict': {'train': 3}}, f)
    argv = ['--infos_path', str(src / 'infos_up.pkl'), '--model',
            str(src / 'model.pth'), '--id', 'imp']
    spec = importlib.util.spec_from_file_location(
        'import_tool', os.path.join(REPO, 'tools',
                                    'import_torch_checkpoint_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv + ['--output_dir', str(tmp_path / 'port')])
    jax_tool_main(os.path.join(REPO, 'tools', 'import_torch_checkpoint.py'),
                  argv + ['--output_dir', str(tmp_path / 'jax')],
                  monkeypatch)
    return tmp_path / 'port', tmp_path / 'jax'


@pytest.mark.parametrize('key', KEYS)
def test_import_tool_writes_the_jax_tools_run_directory(tmp_path,
                                                        monkeypatch, key):
    from captioning_tpu_torch.utils.misc import load_flat, pickle_load
    port, jax_dir = _tool(tmp_path, monkeypatch, key)
    got, want = load_flat(str(port / 'model.npz')), load_flat(
        str(jax_dir / 'model.npz'))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    infos = [pickle_load(open(d / 'infos_imp.pkl', 'rb'))
             for d in (port, jax_dir)]
    assert infos[0]['loader_state_dict'] is None
    assert infos[0]['vocab'] == infos[1]['vocab']
    assert vars(infos[0]['opt']) == vars(infos[1]['opt'])
    if key not in DECODED:
        return

    # the run directory decodes alike in both packages
    from captioning_tpu.engine import decoding as jdec
    from captioning_tpu_torch.models.api import setup
    opt, jcap, _, _ = sides(key)
    pcap = setup(opt, tiny_vocab(), device='cpu').load_params(
        str(port / 'model.npz'))
    from captioning_tpu.utils.misc import load_pytree
    jvars = jax.tree.map(jnp.asarray, load_pytree(str(jax_dir /
                                                      'model.npz')))
    fc, att, am = inputs(4)
    jin = [jnp.asarray(x) for x in (fc, att, am)]
    pin = [torch.from_numpy(x) for x in (fc, att, am)]
    dm = jcap.bind(jvars)
    rng = jax.random.PRNGKey(0)
    greedy = {'sample_method': 'greedy', 'beam_size': 1}
    beam = {'sample_method': 'greedy', 'beam_size': 3}
    jg, _ = jdec.sample(dm, *jin, rng, greedy, return_stats=True)
    pg, _ = pcap.sample_stats(*pin, None, greedy)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    jb, _, _ = jdec.sample_beam(dm, *jin, rng, beam, want_logps=False)
    pb, _, _ = pcap.sample_beam(*pin, None, beam)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
