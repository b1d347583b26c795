"""The port's cooperative ``eval_split`` on two CPU ranks (gloo) against the
JAX package's one-device ``eval_split`` on the same loader: 7 images in
batches of 5 and 2, so each global batch is padded to a multiple of the
world (6 and 2 rows), rank 1's first slice ends in a pad row and each
rank decodes one image of the second.  At beam 3 and greedy, for the
transformer (kernels B1 and B2 by their twins): the merged predictions
equal the JAX ones token for token and in order, on both ranks, and the
val loss (the global mask sum's mean) is within 1e-5."""

import jax
import numpy as np
import pytest
import torch

from tests.torch_parallel_util import ArrayLoader, collect, start_ranks
from tests.torch_port_util import inputs, tiny_vocab, train_batch
from tests.torch_train_util import model_opt

N_IMAGES, BATCH = 7, 5
MODELS = {'transformer': dict(N_enc=1, N_dec=1)}
KWARGS = [dict(beam_size=3, sample_method='greedy'),
          dict(beam_size=1, sample_method='greedy')]


def _kwargs(model):
    return [dict(kw, num_images=N_IMAGES, language_eval=0, verbose=False,
                 id='pe_' + model, split='val', seed=0) for kw in KWARGS]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{model: (the JAX evals, [rank 0's, rank 1's])}, each a list of
    (val loss, predictions) a decode of ``KWARGS``."""
    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu.utils import eval_utils as jax_eval
    from captioning_tpu_torch.models.api import setup
    root = tmp_path_factory.mktemp('parallel_eval')
    fc, att, am = inputs(N_IMAGES)
    labels, masks = train_batch(N_IMAGES, 5)
    arrays = {'fc_feats': fc, 'att_feats': att, 'att_masks': am,
              'labels': labels, 'masks': masks}
    cases = {}
    for model, kw in MODELS.items():
        opt = model_opt(model, **kw)
        pcap = setup(opt, tiny_vocab(), device='cpu')
        pcap.init_params(torch.Generator().manual_seed(1))
        cases[model] = dict(opt=opt, variables=pcap.jax_variables(),
                            arrays=arrays, batch_size=BATCH,
                            kwargs=_kwargs(model))
    procs, outs = start_ranks(root, 'eval_cases', cases)
    want = {}
    cwd = root / 'jax'
    cwd.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        for model, case in cases.items():
            jcap = jax_setup(case['opt'], tiny_vocab())
            variables = jax.tree.map(np.asarray, case['variables'])
            want[model] = []
            for kwargs in case['kwargs']:
                loader = ArrayLoader(arrays, BATCH, tiny_vocab())
                loss, preds, _ = jax_eval.eval_split(jcap, variables, loader,
                                                     dict(kwargs))
                want[model].append((loss, preds))
    got = collect(procs, outs, timeout=300)
    return {model: (want[model], [r[model] for r in got])
            for model in cases}


@pytest.mark.parametrize('decode', range(len(KWARGS)),
                         ids=['beam3', 'greedy'])
@pytest.mark.parametrize('model', MODELS)
def test_cooperative_eval_split_equals_one_device(runs, model, decode):
    want, ranks = runs[model]
    w_loss, w_preds = want[decode]
    assert [p['image_id'] for p in w_preds] == list(range(100, 107))
    for loss, preds in (r[decode] for r in ranks):
        assert [(p['image_id'], p['caption']) for p in preds] == \
            [(p['image_id'], p['caption']) for p in w_preds]
        np.testing.assert_allclose(
            [p['perplexity'] for p in preds],
            [p['perplexity'] for p in w_preds], rtol=1e-4)
        assert loss == pytest.approx(w_loss, rel=1e-5)
