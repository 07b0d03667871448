"""The port's fresh weights against the JAX package's init, tensor by tensor.

Each network and head is built on both sides at a small size; the JAX init
is carried into the port's names by ``interop.from_jax``, and each of the
port's own fresh tensors is held to its JAX counterpart's distribution:
a tensor that starts constant (a zero bias, a unit BN scale) starts at the
same constant, and a random one of at least 2,048 entries has a mean within
a tenth of the JAX tensor's standard deviation and a standard deviation
within 6 % of it (the spread of a 2,048-draw estimate is about 1.6 %;
torch's default draw for a dense or convolution weight is 42 % narrower).
The flagship E-TDNN's
short-crop recipe learns from Flax's dense and convolution init and not
from torch's, so a layer left at torch's default fails here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplip_tpu.losses import softmax as JS
from deeplip_tpu.models import audio_resnet as JAR
from deeplip_tpu.models import fusion as JF
from deeplip_tpu.models import lipreading as JL
from deeplip_tpu.models import tdnn as JT
from deeplip_tpu_torch.interop import from_jax as FJ
from deeplip_tpu_torch.losses.softmax import LMCL, CrossEntropyHead
from deeplip_tpu_torch.models.audio_resnet import AudioResNet
from deeplip_tpu_torch.models.fusion import LinearFusion, LowFER
from deeplip_tpu_torch.models.lipreading import Lipreading
from deeplip_tpu_torch.models.tdnn import SpeakerEmbNet

torch.set_num_threads(1)

MIN_RANDOM = 2048        # entries below which a random tensor's statistics are not read
STD_RTOL = 0.06
MEAN_ATOL = 0.1          # in units of the JAX tensor's standard deviation

CONTEXTS = ((-2, -1, 0, 1, 2), (0,), (-2, 0, 2), (0,))
HIDDEN = (96, 96, 96, 160)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _etdnn():
    x = jnp.zeros((2, 30, 24))
    v = JT.SpeakerEmbNet(contexts=CONTEXTS, hidden_dims=HIDDEN, embedding_dim=128).init(
        jax.random.PRNGKey(0), x)
    want = FJ.speaker_embnet_state_dict(_np(v["params"]), _np(v["batch_stats"]))
    return want, SpeakerEmbNet([list(c) for c in CONTEXTS], list(HIDDEN), embedding_dim=128)


def _lipreading():
    kw = dict(num_classes=10, hidden_dim=16, tcn_kernel_sizes=(3, 5), tcn_num_layers=2,
              tcn_dropout=0.0, trunk_layers=(1, 1, 1, 1))
    v = JL.Lipreading(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 44, 44, 1)))
    want = FJ.lipreading_state_dict(_np(v["params"]), _np(v["batch_stats"]))
    return want, Lipreading(**kw)


def _audio_resnet():
    v = JAR.AudioResNet(stage_widths=(16, 32, 32), stage_blocks=(1, 1, 1),
                        embedding_dim=64).init(jax.random.PRNGKey(0), jnp.zeros((2, 20, 24)))
    want = FJ.audio_resnet_state_dict(_np(v["params"]), _np(v["batch_stats"]))
    return want, AudioResNet([16, 32, 32], [1, 1, 1], 64)


def _linear_fusion():
    v = JF.LinearFusion(hidden_size=256).init(jax.random.PRNGKey(0), jnp.zeros((2, 192)))
    want = FJ.linear_fusion_state_dict(_np(v["params"]), _np(v["batch_stats"]))
    return want, LinearFusion(192, hidden_size=256)


def _lowfer_gate():
    v = JF.LowFER(input_dims=(128, 96), k=4, output_dim=8).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 128)), jnp.zeros((2, 96)))
    want = FJ.lowfer_state_dict(_np(v["params"]))
    return want, LowFER((128, 96), k=4, output_dim=8)


def _criterion(jax_head, port_head):
    def build():
        e = jnp.ones((2, 128))
        v = jax_head(num_classes=40).init(jax.random.PRNGKey(0), e, jnp.zeros((2,), jnp.int32))
        return FJ.criterion_state_dict(_np(v["params"])), port_head(40, 128)
    return build


CASES = {"etdnn": _etdnn, "lipreading": _lipreading, "audio_resnet": _audio_resnet,
         "linear_fusion": _linear_fusion, "lowfer_gate": _lowfer_gate,
         "cross_entropy": _criterion(JS.CrossEntropyHead, CrossEntropyHead),
         "lmcl": _criterion(JS.LMCL, LMCL)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fresh_weights_follow_the_jax_init(case):
    torch.manual_seed(0)
    want, net = CASES[case]()
    got = net.state_dict()
    assert set(want) <= set(got), sorted(set(want) - set(got))
    read = 0
    for key, w in want.items():
        w = w.double().numpy()
        g = got[key].double().numpy()
        assert g.shape == w.shape, key
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, np.full_like(w, w.flat[0]), err_msg=key)
            continue
        if w.size < MIN_RANDOM:
            continue
        read += 1
        sd = w.std()
        assert g.std() == pytest.approx(sd, rel=STD_RTOL), key
        assert abs(g.mean() - w.mean()) <= MEAN_ATOL * sd, key
    assert read > 0
