"""Reference torch checkpoints into the port: ``utils/torch_migrate.py``.

Each test builds a torch twin of a reference family (the MLP, the
CNN-LSTM with a 2-layer ``nn.LSTM``, DenseNet-BC with the reference's
double module registration) and loads its ``state_dict`` into the port
two ways: directly (``state_dict_from_reference``), and through flax
(the JAX package's importer, then the port's ``load_flax_variables``).
The twin's forward and both ports' must agree within 1e-5 of max|ref|.
"""

import io

import jax
import numpy as np
import pytest
import torch

from distributed_deep_learning_tpu.models import cnn_lstm as jlstm
from distributed_deep_learning_tpu.models import densenet as jdn
from distributed_deep_learning_tpu.models import mlp as jmlp
from distributed_deep_learning_tpu.utils import torch_migrate as jmig
from distributed_deep_learning_tpu_torch.models import cnn_lstm as tlstm
from distributed_deep_learning_tpu_torch.models import densenet as tdn
from distributed_deep_learning_tpu_torch.models import mlp as tmlp
from distributed_deep_learning_tpu_torch.utils.torch_migrate import \
    state_dict_from_reference
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

TOL = 1e-5


def _mlp_twin():
    return torch.nn.Sequential(
        torch.nn.Linear(48, 38), torch.nn.ReLU(),
        torch.nn.Linear(38, 38), torch.nn.ReLU(),
        torch.nn.Linear(38, 38), torch.nn.ReLU(),
        torch.nn.Linear(38, 5))


class _LSTMTwin(torch.nn.Module):
    """The reference CNN-LSTM dataflow: Conv1d over time-as-channels, a
    2-layer LSTM over the conv channels, final hidden state → Linear."""

    def __init__(self, hidden=32):
        super().__init__()
        self.conv = torch.nn.Conv1d(10, 64, kernel_size=1)
        self.lstm = torch.nn.LSTM(32, hidden, num_layers=2,
                                  batch_first=True)
        self.head = torch.nn.Linear(hidden, 5)

    def forward(self, x):
        out, (h, _) = self.lstm(torch.relu(self.conv(x)))
        return self.head(h[-1])


GROWTH, BN_SIZE, BLOCKS, PER_BLOCK = 8, 4, 2, 2


def _bn(c):
    return torch.nn.BatchNorm2d(c, eps=1e-3)


class _DenseInner(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm1 = _bn(c)
        self.conv1 = torch.nn.Conv2d(c, BN_SIZE * GROWTH, 1, bias=False)
        self.norm2 = _bn(BN_SIZE * GROWTH)
        self.conv2 = torch.nn.Conv2d(BN_SIZE * GROWTH, GROWTH, 3,
                                     padding=1, bias=False)

    def forward(self, x):
        y = self.conv1(torch.relu(self.norm1(x)))
        return torch.cat([x, self.conv2(torch.relu(self.norm2(y)))], 1)


class _DenseLayerTwin(torch.nn.Module):
    """The reference's ``WrapperTriton`` registers its layer twice."""

    def __init__(self, c):
        super().__init__()
        self.layer = _DenseInner(c)
        self.add_module("DenseLayer", self.layer)

    def forward(self, x):
        return self.layer(x)


class _DenseNetTwin(torch.nn.Module):
    def __init__(self):
        super().__init__()
        c = 2 * GROWTH
        self.stem = torch.nn.Conv2d(3, c, 7, stride=2, padding=3, bias=False)
        self.stem_norm = _bn(c)
        mods = []
        for b in range(BLOCKS):
            for _ in range(PER_BLOCK):
                mods.append(_DenseLayerTwin(c))
                c += GROWTH
            if b < BLOCKS - 1:
                trans = torch.nn.Sequential()
                trans.add_module("norm", _bn(c))
                trans.add_module("conv", torch.nn.Conv2d(c, c // 2, 1,
                                                         bias=False))
                mods.append(trans)
                c //= 2
        self.features = torch.nn.ModuleList(mods)
        self.head = torch.nn.Linear(c, 6)

    def forward(self, x):
        x = torch.nn.functional.max_pool2d(
            torch.relu(self.stem_norm(self.stem(x))), 3, 2, padding=1)
        for m in self.features:
            if isinstance(m, _DenseLayerTwin):
                x = m(x)
            else:
                x = torch.nn.functional.avg_pool2d(
                    m.conv(torch.relu(m.norm(x))), 2, 2)
        k = min(7, x.shape[2], x.shape[3])
        x = torch.nn.functional.avg_pool2d(x, k, k)
        return self.head(torch.flatten(x, 1))


def _densenet_twin():
    tm = _DenseNetTwin()
    tm.train()                 # non-trivial running statistics
    with torch.no_grad():
        tm(torch.randn(8, 3, 64, 64,
                       generator=torch.Generator().manual_seed(3)))
    return tm


#: family -> (twin, port model, flax model, JAX importer, port loader,
#: input shape, NHWC → twin layout)
FAMILIES = {
    "mlp": (_mlp_twin, lambda: tmlp.MLP(48, 38, num_hidden_layers=2),
            lambda: jmlp.MLP(hidden_size=38, num_hidden_layers=2),
            jmig.mlp_params_from_torch, tmlp.load_flax_variables,
            (4, 48), None),
    "cnn_lstm": (_LSTMTwin,
                 lambda: tlstm.CNNLSTM(hidden_layers=2, hidden_size=32),
                 lambda: jlstm.CNNLSTM(hidden_layers=2, hidden_size=32),
                 jmig.cnn_lstm_params_from_torch,
                 tlstm.load_flax_variables, (4, 10, 32), None),
    "densenet": (_densenet_twin,
                 lambda: tdn.DenseNet(dense_blocks=BLOCKS,
                                      dense_layers=PER_BLOCK,
                                      growth_rate=GROWTH, bn_size=BN_SIZE),
                 lambda: jdn.DenseNet(dense_blocks=BLOCKS,
                                      dense_layers=PER_BLOCK,
                                      growth_rate=GROWTH, bn_size=BN_SIZE),
                 jmig.densenet_params_from_torch, tdn.load_flax_variables,
                 (2, 64, 64, 3), (0, 3, 1, 2)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reference_checkpoint_loads_into_the_port(family):
    twin, port, flax_model, importer, loader, shape, perm = \
        FAMILIES[family]
    torch.manual_seed(0)
    tm = twin().eval()
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x if perm is None else x.transpose(perm))
    with torch.no_grad():
        want = tm(xt.contiguous()).numpy()
    # a saved and reloaded checkpoint keeps the aliases' shared storage
    buf = io.BytesIO()
    torch.save(tm.state_dict(), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    direct = port().eval()
    direct.load_state_dict(state_dict_from_reference(direct, saved))
    variables = importer(tm.state_dict(), flax_model(), x[:1])
    via_flax = port().eval()
    via_flax.load_state_dict(loader(jax.tree.map(np.asarray,
                                                 dict(variables))))
    scale = float(np.abs(want).max())
    with torch.no_grad():
        for got in (direct(torch.from_numpy(x)),
                    via_flax(torch.from_numpy(x))):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=TOL * scale)


def test_numpy_round_trip_drops_the_aliased_group():
    tm = _densenet_twin().eval()
    rt = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    model = FAMILIES["densenet"][1]()
    model.load_state_dict(state_dict_from_reference(model, rt))
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        np.testing.assert_allclose(
            model.eval()(x).numpy(),
            tm(x.permute(0, 3, 1, 2).contiguous()).numpy(), rtol=0,
            atol=1e-5)


@pytest.mark.parametrize("case", ["wrong_family", "too_many_layers",
                                  "bidirectional"])
def test_mismatched_checkpoints_are_refused(case):
    if case == "wrong_family":
        sd = torch.nn.Sequential(torch.nn.Conv1d(4, 8, 1),
                                 torch.nn.Linear(8, 38),
                                 torch.nn.Linear(38, 5)).state_dict()
        model, match = tmlp.MLP(48), "expects 'linear'"
    elif case == "too_many_layers":
        sd = _mlp_twin().state_dict()
        model, match = tmlp.MLP(48, 38, num_hidden_layers=1), "another size"
    else:
        sd = torch.nn.LSTM(32, 16, bidirectional=True).state_dict()
        model, match = tlstm.CNNLSTM(hidden_size=16), "unsupported leaves"
    with pytest.raises(ValueError, match=match):
        state_dict_from_reference(model, sd)
