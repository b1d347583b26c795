"""AoANet's train steps (``modules/trainer.py``) against the JAX package's,
float32 on the CPU at tiny widths (rnn 32 in 4 heads, the 6-layer
refiner), and its step programs:

* ``xe_step`` with ``configs/aoa.yml``'s label smoothing 0.2 at
  ``ss_prob`` 0 and at ``ss_prob`` 1 (every token from step 1 on is a
  scheduled-sampling draw; the EOS logit bias is raised by 40, so both
  frameworks draw EOS): 3 steps of adam, the first loss within 1e-5
  relative, the trajectory within 1e-4, the optimizer state within 1e-6;
* ``sc_fused_step``, ``sc_decode`` + ``sc_grad_step`` and
  ``struc_fused_step`` with JAX's sampling noise: the sequences identical,
  the rewards within 1e-5, the trajectory as above;
* the graphed XE and fused SCST entries through ``EagerRecorder`` against
  JAX;
* ``NoHostRead`` over AoA's decode step bodies (beam, greedy) and its
  train-step bodies (XE, fused SCST, SCST grad, fused structure), and the
  decode carry at fixed addresses.

The parity tests set every dropout rate to 0 on both sides (the two
frameworks' random streams never agree): ``drop_prob_lm``,
``dropout_aoa`` and the sites at the JAX module's literal 0.1 (the
refiner's and the decoder attention's), which the JAX module takes from
its ``Dropout`` and the port from ``models.aoa.DROPOUT``; the program
checks run with dropout on."""

import pytest
import torch

from captioning_tpu_torch.models import aoa as paoa
from tests import test_torch_graph_decode as graph_decode
from tests import test_torch_graph_train as graph_train
from tests import test_torch_scst as scst
from tests import test_torch_struc as struc
from tests.torch_port_util import tiny_aoa_opt
from tests.torch_rl_util import write_df
from tests.torch_train_util import (check_losses, check_opt_state,
                                    model_opt, run_both)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_fixed_dropout(monkeypatch):
    """The sites at the literal rate 0.1 at 0 on both sides."""
    from captioning_tpu.models import aoa as jaoa
    from captioning_tpu.models.layers import Dropout
    monkeypatch.setattr(jaoa, 'Dropout', lambda rate: Dropout(0.0))
    monkeypatch.setattr(paoa, 'DROPOUT', 0.0)


@pytest.fixture(scope='module')
def df(tmp_path_factory):
    return write_df(tmp_path_factory.mktemp('aoa_train'))


@pytest.mark.usefixtures('no_fixed_dropout')
@pytest.mark.parametrize('ss_prob', [0.0, 1.0])
def test_xe_step_matches_jax(ss_prob):
    want, got, _, state, _, pt = run_both(
        model_opt('aoa', label_smoothing=0.2), ss_prob=ss_prob,
        eos_boost=40.0 if ss_prob else 0.0)
    check_losses(want, got)
    check_opt_state(state, pt)


@pytest.mark.usefixtures('no_fixed_dropout')
def test_sc_fused_step_matches_jax(df):
    scst.test_sc_fused_step_matches_jax(df[0], 'aoa')


@pytest.mark.usefixtures('no_fixed_dropout')
def test_sc_decode_and_grad_step_match_jax(df):
    scst.test_sc_decode_and_grad_step_match_jax(df[0], 'aoa')


@pytest.mark.usefixtures('no_fixed_dropout')
def test_struc_fused_step_matches_jax(df):
    struc.test_struc_fused_step_matches_jax(df[0], 'aoa')


@pytest.mark.usefixtures('no_fixed_dropout')
def test_graphed_xe_step_matches_jax():
    graph_train.test_graphed_xe_step_matches_jax('aoa')


@pytest.mark.usefixtures('no_fixed_dropout')
def test_graphed_sc_fused_step_matches_jax(df):
    graph_train.test_graphed_sc_fused_step_matches_jax(df, 'aoa')


def test_fused_equals_unfused_under_dropout(df):
    """Under dropout (the literal 0.1 sites, the gate's 0.3 and
    ``drop_prob_lm`` 0.5) the fused SCST step equals sc_decode +
    sc_grad_step: the recompute draws the decode's masks again."""
    scst.test_fused_equals_unfused_under_dropout(df[0], 'aoa')


@pytest.mark.parametrize('kind', ['xe', 'sc_fused', 'sc_grad',
                                  'struc_fused'])
def test_train_step_body_reads_nothing_on_the_host(kind, df):
    graph_train.test_step_body_reads_nothing_on_the_host(kind, 'aoa', df)


@pytest.mark.parametrize('kind', ['beam', 'greedy'])
def test_decode_step_body_reads_nothing_on_the_host(kind, monkeypatch):
    monkeypatch.setitem(graph_decode.MODELS, 'aoa', tiny_aoa_opt)
    graph_decode.test_step_body_reads_nothing_on_the_host('aoa', kind)
    graph_decode.test_carried_tensors_keep_their_addresses('aoa', kind)
