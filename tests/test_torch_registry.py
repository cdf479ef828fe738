"""ray_tpu_torch.models.registry held against ray_tpu.models.registry.

Every dense preset and every ``config_from_hf`` mapping must give the
reference's fields (dtypes mapped jnp -> torch); the MoE names and a
Mixtral config raise NotImplementedError until the MoE decoder is ported;
and an engine built from a registry name gives the reference engine's
greedy tokens on the same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.engine import EngineConfig as JEngineConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.llm.sampling import SamplingParams as JSamplingParams
from ray_tpu.models import registry as jreg
from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import registry as treg

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
MOE_NAMES = ("mixtral-8x7b", "moe-tiny")

HF_DICTS = {
    # tests/test_model_registry.py's llama dict
    "llama": {
        "architectures": ["LlamaForCausalLM"],
        "vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "max_position_embeddings": 128,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True,
    },
    "mistral": {
        "architectures": ["MistralForCausalLM"],
        "vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "intermediate_size": 14336, "max_position_embeddings": 32768,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-5, "head_dim": 128,
        "rope_scaling": None,
    },
    "qwen2": {
        "architectures": ["Qwen2ForCausalLM"],
        "vocab_size": 152064, "hidden_size": 3584, "num_hidden_layers": 28,
        "num_attention_heads": 28, "num_key_value_heads": 4,
        "intermediate_size": 18944, "max_position_embeddings": 32768,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": False, "rope_scaling": {"rope_type": "default"},
    },
    # no architectures, no num_key_value_heads (MHA), defaults elsewhere
    "bare": {
        "vocab_size": 1000, "hidden_size": 96, "num_hidden_layers": 3,
        "num_attention_heads": 6, "intermediate_size": 256,
    },
}

REFUSED = {
    # tests/test_model_registry.py's unknown architecture
    "unknown_arch": ({
        "architectures": ["GPTBigCodeForCausalLM"],
        "vocab_size": 1, "hidden_size": 8, "num_hidden_layers": 1,
        "num_attention_heads": 1, "intermediate_size": 8,
    }, "unsupported architectures"),
    "rope_scaling_llama3": ({
        **HF_DICTS["llama"],
        "rope_scaling": {"rope_type": "llama3", "factor": 8.0},
    }, "rope_scaling"),
    "head_dim_mismatch": ({**HF_DICTS["llama"], "head_dim": 32}, "head_dim"),
}

# tests/test_model_registry.py's Mixtral dict, and a dict with no
# architectures that carries num_local_experts (mapped onto Mixtral)
MIXTRAL = {
    "architectures": ["MixtralForCausalLM"],
    "vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 128, "num_local_experts": 4,
    "num_experts_per_tok": 2,
}
MOE_BARE = {k: v for k, v in MIXTRAL.items() if k != "architectures"}


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    for k in ("dtype", "param_dtype"):
        out[k] = DTYPES.get(out[k], out[k])
    return out


def test_same_names_in_both_registries():
    assert treg.list_models() == jreg.list_models()
    assert set(MOE_NAMES) <= set(treg.list_models())


@pytest.mark.parametrize("name", [n for n in jreg.list_models() if n not in MOE_NAMES])
def test_dense_preset_fields_equal_reference(name):
    ref = jreg.get_model_config(name)
    got = treg.get_model_config(name)
    assert isinstance(got, tllama.LlamaConfig)
    assert _fields(got) == _fields(ref)
    assert got.head_dim == ref.head_dim and got.num_params() == ref.num_params()


def test_lookup_case_insensitive_duplicate_and_unknown():
    assert treg.get_model_config("LLAMA3-8B") is treg.get_model_config("llama3-8b")
    with pytest.raises(KeyError) as jerr:
        jreg.get_model_config("nope-13b")
    with pytest.raises(KeyError) as terr:
        treg.get_model_config("nope-13b")
    assert str(terr.value) == str(jerr.value)  # lists the same names
    with pytest.raises(ValueError, match="already registered"):
        treg.register_model("Llama3-8B", tllama.LLAMA_TINY)
    assert treg.list_models() == jreg.list_models()


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_names_refused(name):
    jreg.get_model_config(name)  # the reference has them
    with pytest.raises(NotImplementedError, match="D3"):
        treg.get_model_config(name)
    with pytest.raises(NotImplementedError, match="D3"):
        EngineConfig(model=name)


@pytest.mark.parametrize("key", sorted(HF_DICTS))
def test_config_from_hf_fields_equal_reference(key):
    hf = HF_DICTS[key]
    assert _fields(treg.config_from_hf(hf)) == _fields(jreg.config_from_hf(hf))
    over = dict(remat=False, max_seq=64)
    assert _fields(treg.config_from_hf(hf, **over)) == _fields(jreg.config_from_hf(hf, **over))


@pytest.mark.parametrize("key", sorted(REFUSED))
def test_config_from_hf_refusals_match_reference(key):
    hf, match = REFUSED[key]
    with pytest.raises(ValueError, match=match) as jerr:
        jreg.config_from_hf(hf)
    with pytest.raises(ValueError, match=match) as terr:
        treg.config_from_hf(hf)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("hf", [MIXTRAL, MOE_BARE], ids=["mixtral", "experts_no_arch"])
def test_mixtral_config_refused(hf):
    assert jreg.config_from_hf(hf).n_experts == 4  # the reference maps it
    with pytest.raises(NotImplementedError, match="D3"):
        treg.config_from_hf(hf)
    # the whitelist still comes first: an unknown architecture with experts
    bad = {**hf, "architectures": ["PhiMoEForCausalLM"]}
    with pytest.raises(ValueError, match="unsupported architectures"):
        treg.config_from_hf(bad)


def test_engine_from_registry_name_matches_reference():
    """EngineConfig(model="llama-tiny") resolves through the registry in
    both packages and serves as the reference's test has it (bf16, 4
    tokens). Token identity is the fp32 contract: the same resolved
    configs at fp32, the reference engine's weights carried over, give the
    same greedy tokens."""
    kw = dict(num_blocks=32, block_size=4, max_num_seqs=2)
    jcfg = JEngineConfig(model="llama-tiny", **kw)
    tcfg = EngineConfig(model="llama-tiny", **kw)
    assert tcfg.model is tllama.LLAMA_TINY and jcfg.model.d_model == tcfg.model.d_model == 64
    assert _fields(tcfg.model) == _fields(jcfg.model)
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13]]
    sp = dict(max_tokens=4, temperature=0.0, ignore_eos=True)
    out = LLMEngine(tcfg, device="cpu").generate(prompts, SamplingParams(**sp))
    assert [len(o) for o in out] == [4, 4]

    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, dtype=jnp.float32))
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, dtype=torch.float32))
    jeng = JLLMEngine(jcfg)
    ref = jeng.generate(prompts, JSamplingParams(**sp))
    tree = jax.tree.map(np.asarray, jeng.params)
    eng = LLMEngine(tcfg, params=tllama.params_from_numpy(tree, tcfg.model, device="cpu"),
                    device="cpu")
    assert eng.generate(prompts, SamplingParams(**sp)) == ref
