"""Optimizers and learning-rate schedules on ``torch.optim``.

The port's copy of ``captioning_tpu/utils/optimizers.py``: the seven
``--optim`` values with the reference's torch constructors (weight decay
added to the gradient for all but adamw, RMSprop's eps outside the sqrt,
Adagrad with torch's defaults), the noam optimizer, the gradient clip, and
the host-side schedules (``noam_rate``, ``epoch_decay_lr``,
``ReduceLROnPlateau``).  The learning rate is set on the param groups
before every step (``set_lr``), as the JAX trainer injects it.  Built
``capturable`` (on the card, for the optimizers of ``CAPTURABLE``), the
optimizer keeps its step count on the device and reads the learning rate
from a 0-d tensor on the device that ``set_lr`` fills: its update then
reads nothing on the host, and a CUDA graph holds it (``engine.graphs``).

``state_to_jax`` / ``state_from_jax`` map the optimizer state to and from
the JAX package's ``optimizer.npz`` layout, the flattened optax chain
``(clip, optimizer)``: for adam ``#1/#0/#0`` is the step count (int32),
``#1/#0/#1/<param path>`` the first moment and ``#1/#0/#2/<param path>``
the second, one chain slot later (``#1/#1/...``) when a coupled weight
decay leads the chain; the parameter paths go through the weight bridge,
so either package resumes the other's run.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .weights import jax_from_state_dict, state_dict_from_jax

_ADAM = {'exp_avg': '#1', 'exp_avg_sq': '#2'}


# the --optim values whose torch.optim update a CUDA graph holds: each has a
# capturable mode and reads a learning rate held in a device tensor
CAPTURABLE = ('adam', 'adamw', 'rmsprop')
_SGD_WHY = ('torch.optim.SGD has no capturable mode and applies the '
            'learning rate as a host scalar (alpha=-lr): a graph would '
            'freeze one rate')
# why each other --optim keeps its update out of a graph
NOT_CAPTURABLE = {
    'sgd': _SGD_WHY, 'sgdm': _SGD_WHY, 'sgdmom': _SGD_WHY,
    'adagrad': ('torch.optim.Adagrad has no capturable mode: its step '
                'count lives on the host, where a graph never advances it'),
}


def graph_route(opt) -> str:
    """'' when ``opt``'s optimizer (``--optim``, noam builds adam or
    adamw) is captured with the train step, else why it is not."""
    name = getattr(opt, 'optim', 'adam')
    if name in CAPTURABLE:
        return ''
    return NOT_CAPTURABLE.get(name, 'unknown optim %r' % name)


def _lr(lr, params, capturable: bool):
    """The param group's learning rate: a float32 0-d tensor on the
    parameters' device for a capturable optimizer, else the float."""
    if not capturable:
        return lr
    return torch.tensor(float(lr), dtype=torch.float32,
                        device=params[0].device)


def build_optimizer(opt, params, capturable: bool = False
                    ) -> torch.optim.Optimizer:
    """The reference's optimizer for ``opt.optim`` (reference
    misc.py:114-130); ``capturable`` (an optimizer of ``CAPTURABLE``, CUDA
    parameters) builds it in torch's capturable mode with a tensor
    learning rate."""
    name = opt.optim
    if capturable and name not in CAPTURABLE:
        raise ValueError('optim %r: %s' % (name, graph_route(opt)))
    params = list(params)
    lr = _lr(opt.learning_rate, params, capturable)
    wd = float(getattr(opt, 'weight_decay', 0) or 0)
    a, b, eps = opt.optim_alpha, opt.optim_beta, opt.optim_epsilon
    cap = {'capturable': True} if capturable else {}
    if name == 'rmsprop':
        return torch.optim.RMSprop(params, lr, a, eps, weight_decay=wd,
                                   **cap)
    if name == 'adagrad':
        return torch.optim.Adagrad(params, lr, weight_decay=wd)
    if name == 'sgd':
        return torch.optim.SGD(params, lr, weight_decay=wd)
    if name == 'sgdm':
        return torch.optim.SGD(params, lr, a, weight_decay=wd)
    if name == 'sgdmom':
        return torch.optim.SGD(params, lr, a, weight_decay=wd, nesterov=True)
    if name == 'adam':
        return torch.optim.Adam(params, lr, (a, b), eps, weight_decay=wd,
                                **cap)
    if name == 'adamw':
        return torch.optim.AdamW(params, lr, (a, b), eps, weight_decay=wd,
                                 **cap)
    raise Exception("bad option opt.optim: {}".format(name))


def build_noam_optimizer(opt, params, capturable: bool = False
                         ) -> torch.optim.Optimizer:
    """The optimizer under NoamOpt (reference misc.py:257-263): adam or
    adamw with betas (0.9, 0.98) and eps 1e-9; adamw keeps torch's default
    weight decay 0.01; any other --optim raises.  ``capturable`` as in
    ``build_optimizer``."""
    name = getattr(opt, 'optim', 'adam')
    params = list(params)
    lr = _lr(0.0, params, capturable)
    cap = {'capturable': True} if capturable else {}
    if name == 'adam':
        return torch.optim.Adam(params, lr, (0.9, 0.98), 1e-9, **cap)
    if name == 'adamw':
        return torch.optim.AdamW(params, lr, (0.9, 0.98), 1e-9,
                                 weight_decay=0.01, **cap)
    raise KeyError('noamopt supports optim adam/adamw, got %r' % name)


def clip_transform(opt) -> Callable:
    """Gradient clip by value or by global norm (reference
    train.py:194-195), applied to the gradients before the step."""
    v = float(opt.grad_clip_value)
    if v == 0:
        return lambda params: None
    if opt.grad_clip_mode == 'value':
        return lambda params: torch.nn.utils.clip_grad_value_(params, v)
    return lambda params: torch.nn.utils.clip_grad_norm_(params, v)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of every param group: written into a capturable
    optimizer's device tensor (which a captured step reads), else set."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group['lr']):
            group['lr'].fill_(lr)
        else:
            group['lr'] = lr


def noam_rate(step: int, d_model: int, factor: float, warmup: int) -> float:
    """reference misc.py:179-185."""
    step = max(step, 1)
    return factor * (d_model ** -0.5) * min(step ** -0.5,
                                            step * warmup ** -1.5)


def epoch_decay_lr(opt, epoch: int) -> float:
    """Manual epoch-wise exponential decay (reference train.py:134-142)."""
    if (opt.learning_rate_decay_start >= 0 and
            epoch > opt.learning_rate_decay_start):
        frac = ((epoch - opt.learning_rate_decay_start) //
                opt.learning_rate_decay_every)
        return opt.learning_rate * (opt.learning_rate_decay_rate ** frac)
    return opt.learning_rate


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics; reference
    misc.py:201-255 wraps torch's)."""

    def __init__(self, initial_lr, mode='min', factor=0.1, patience=10,
                 threshold=1e-4, cooldown=0, min_lr=0):
        self.current_lr = initial_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, val):
        # torch 'rel' threshold_mode semantics
        if self.best is None:
            return True
        if self.mode == 'min':
            return val < self.best * (1 - self.threshold)
        return val > self.best * (1 + self.threshold)

    def step(self, val):
        if self._is_better(val):
            self.best = val
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.current_lr = max(self.current_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def state_dict(self):
        return dict(current_lr=self.current_lr, best=self.best,
                    num_bad_epochs=self.num_bad_epochs,
                    cooldown_counter=self.cooldown_counter)

    def load_state_dict(self, sd):
        if sd is None:
            return
        self.current_lr = sd.get('current_lr', self.current_lr)
        self.best = sd.get('best')
        self.num_bad_epochs = sd.get('num_bad_epochs', 0)
        self.cooldown_counter = sd.get('cooldown_counter', 0)


# -- the JAX package's optimizer.npz layout -----------------------------------

def _layout(opt):
    """(prefix of the optimizer's optax state, {torch state key: optax
    field}, whether the state holds a step count at ``prefix/#0``).  The
    chain is (clip, build_optimizer's chain) or (clip, the noam
    optimizer); clip and weight-decay states are empty."""
    name = getattr(opt, 'optim', 'adam')
    if getattr(opt, 'noamopt', False):
        # noam adam is scale_by_adam itself, noam adamw a chain of it
        return ('#1' if name == 'adam' else '#1/#0'), _ADAM, True
    wd = float(getattr(opt, 'weight_decay', 0) or 0)
    prefix = '#1/#1' if wd > 0 and name != 'adamw' else '#1/#0'
    fields = {'adam': _ADAM, 'adamw': _ADAM,
              'rmsprop': {'square_avg': '#0'}, 'adagrad': {'sum': 'sum'},
              'sgdm': {'momentum_buffer': '#0'},
              'sgdmom': {'momentum_buffer': '#0'}, 'sgd': {}}[name]
    return prefix, fields, name in ('adam', 'adamw')


def state_to_jax(optimizer, opt, named_params: Dict[str, torch.Tensor],
                 cfg) -> Dict[str, np.ndarray]:
    """The optimizer's state as the flat tree the JAX package writes to
    ``optimizer.npz`` (a parameter not stepped yet holds zeros)."""
    prefix, fields, counted = _layout(opt)
    out = {}
    states = [optimizer.state.get(p, {}) for p in named_params.values()]
    if counted:
        step = next((float(st['step']) for st in states if 'step' in st), 0)
        out[prefix + '/#0'] = np.asarray(int(step), np.int32)
    for key, field in fields.items():
        per = {}
        for (name, p), st in zip(named_params.items(), states):
            v = st.get(key)
            per[name] = torch.zeros_like(p) if v is None else v
        for path, value in jax_from_state_dict(per, cfg, True).items():
            out['%s/%s/%s' % (prefix, field, path[len('params/'):])] = value
    return out


def state_from_jax(optimizer, opt, named_params: Dict[str, torch.Tensor],
                   cfg, flat: Dict[str, np.ndarray]) -> None:
    """Load a flat JAX optimizer tree (``misc._flatten_tree`` of
    ``load_pytree('optimizer.npz')``) into ``optimizer``'s state."""
    prefix, fields, counted = _layout(opt)
    flat = dict(flat)
    heads = ['%s/%s/' % (prefix, field) for field in fields.values()]
    if ((counted and prefix + '/#0' not in flat) or any(
            not k.startswith(tuple(heads)) and k != prefix + '/#0'
            for k in flat)):
        raise KeyError('optimizer state: not the layout of optim %r '
                       '(noamopt %s, weight_decay %s): %s'
                       % (getattr(opt, 'optim', ''),
                          getattr(opt, 'noamopt', False),
                          getattr(opt, 'weight_decay', 0), sorted(flat)[:4]))
    step = float(flat.pop(prefix + '/#0')) if counted else 0.0
    per = {}
    for key, head in zip(fields, heads):
        sub = {'params/' + k[len(head):]: flat.pop(k) for k in list(flat)
               if k.startswith(head)}
        per[key] = state_dict_from_jax(sub, cfg, params_only=True)
    stepped = counted or getattr(opt, 'optim', '') in ('rmsprop', 'adagrad')
    # a capturable optimizer counts its steps on the parameters' device
    on_device = optimizer.defaults.get('capturable', False)
    for name, p in named_params.items():
        st = {key: per[key][name].to(p.device, p.dtype) for key in fields}
        if stepped:
            st['step'] = torch.tensor(step, dtype=torch.float32,
                                      device=p.device if on_device else None)
        optimizer.state[p] = st
