"""The port's model configs and registry against the reference's: every
``CONFIG`` and ``smoke_config()`` field for field, the parameter
arithmetic, the input shapes and the registry's lookups."""

import dataclasses

import pytest

from repro.configs import registry as rreg
from repro.models import config as rconf
from repro_torch.configs import registry as treg
from repro_torch.models import config as tconf

from _lm import LM_ARCHS


def test_arch_ids_equal():
    assert treg.ARCH_IDS == rreg.ARCH_IDS
    assert len(treg.ARCH_IDS) == 11


@pytest.mark.parametrize("arch", rreg.ARCH_IDS)
def test_config_and_smoke_config_equal(arch):
    for getter in ("get_config", "get_smoke_config"):
        ref = getattr(rreg, getter)(arch)
        port = getattr(treg, getter)(arch)
        assert type(port).__module__.startswith("repro_torch.")
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_arithmetic_equal(arch):
    for getter in ("get_config", "get_smoke_config"):
        ref = getattr(rreg, getter)(arch)
        port = getattr(treg, getter)(arch)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        for prop in ("attention_free", "pure_full_attention", "d_inner_ssm",
                     "n_ssm_heads"):
            assert getattr(port, prop) == getattr(ref, prop), prop
        assert tconf.applicable_shapes(port) == rconf.applicable_shapes(ref)


def test_qwen2_published_widths():
    """The LM the RAG tenant serves on the card: 494,005,120 parameters by
    ``param_count`` (which leaves out the 27,648 QKV-bias elements)."""
    cfg = treg.get_config("qwen2-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size) == (
        24, 896, 14, 2, 64, 4864, 151_936)
    assert cfg.qkv_bias and cfg.rope_theta == 1e6 and cfg.tie_embeddings
    assert cfg.param_count() == 494_005_120


def test_shapes_and_moe_slots_equal():
    assert {k: dataclasses.asdict(v) for k, v in tconf.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rconf.SHAPES.items()}
    for e, pad in ((8, 0), (8, 16), (384, 0)):
        assert (tconf.MoECfg(e, 2, 64, pad_to=pad).n_slots
                == rconf.MoECfg(e, 2, 64, pad_to=pad).n_slots)


def test_registry_lookups():
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("gpt-2")
    assert treg.serve_config_ids() == rreg.serve_config_ids()
    for name in treg.serve_config_ids():
        port = treg.get_serve_config(name).to_dict()
        # the port's own search knob (the LUT-kernel switch), at its default
        assert port["search"].pop("lut_impl") == "einsum"
        assert port == rreg.get_serve_config(name).to_dict()
    with pytest.raises(KeyError, match="unknown serve config"):
        treg.get_serve_config("nope")
