"""`rvc_tpu_torch.utils.weights` carries JAX parameter trees into the
port's modules under the upstream torch names and layouts."""

import numpy as np
import pytest

from rvc_tpu.utils import weights as W
from rvc_tpu_torch.models.hubert import HubertConfig, HubertModel
from rvc_tpu_torch.models.rmvpe import E2E
from rvc_tpu_torch.models.synthesizer import build_synthesizer
from rvc_tpu_torch.configs import get_config as port_get_config
from rvc_tpu_torch.utils import weights as PW
from torch_port_helpers import (
    SMALL_HUBERT,
    SMALL_RMVPE,
    SMALL_SYNTH_ARGS,
    huberts,
    numpy_state,
    rmvpes,
    synthesizers,
)


def _assert_same(got, ref, rtol=0.0, atol=0.0):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        g = got[k].numpy() if hasattr(got[k], "numpy") else got[k]
        assert g.shape == v.shape, k
        np.testing.assert_allclose(g, v, rtol=rtol, atol=atol, err_msg=k)


def test_synthesizer_matches_reference_export():
    """Key for key equal to the reference's own torch export once its
    weight-norm split is folded back (a round trip through g * v / |v|:
    float32 rounding, rtol 1e-5)."""
    _, _, params = synthesizers()
    ref = W.fuse_weight_norm(W.synthesizer_params_to_torch_state_dict(params))
    _assert_same(PW.synthesizer_from_jax(params), ref, rtol=1e-5, atol=1e-7)


def test_synthesizer_drops_posterior_encoder_and_loads_strict():
    port, _, params = synthesizers()
    with_q = {**params, "enc_q": {"pre": {"weight": np.zeros((1, 4, 8), np.float32)}}}
    sd = PW.synthesizer_from_jax(with_q)
    assert not any(k.startswith("enc_q") for k in sd)
    fresh = build_synthesizer(port_get_config(32000, **SMALL_SYNTH_ARGS))
    fresh.load_state_dict(sd, strict=True)
    _assert_same({k: v.numpy() for k, v in fresh.state_dict().items()}, numpy_state(port))


def test_hubert_round_trip_exact():
    """Pure transposes and renames: the port's state dict comes back bit
    for bit through the reference's converter and `hubert_from_jax`."""
    port, _, params = huberts()
    sd = PW.hubert_from_jax(params)
    HubertModel(HubertConfig(**SMALL_HUBERT)).load_state_dict(sd, strict=True)
    _assert_same(sd, numpy_state(port))


def test_rmvpe_round_trip_exact():
    port, _, variables = rmvpes()
    sd = PW.rmvpe_from_jax(variables["params"], variables["batch_stats"])
    E2E(**SMALL_RMVPE).load_state_dict(sd, strict=True)
    _assert_same(sd, numpy_state(port))


def test_unmapped_path_raises():
    with pytest.raises(ValueError, match="no port parameter"):
        PW.hubert_from_jax({"mystery": {"weight": np.zeros(3, np.float32)}})
