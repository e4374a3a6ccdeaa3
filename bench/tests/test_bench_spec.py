"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files."""

import json
import re

import pytest

import bench_tiny  # noqa: F401  (puts the benchmark on sys.path)
from vsrbench import spec as S

SPEC = S.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# DeepSeek-V2's published config.json (huggingface.co/deepseek-ai/DeepSeek-V2)
DEEPSEEK_V2 = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 5120, "intermediate_size": 12288, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1536, "moe_layer_freq": 1, "n_group": 8,
    "n_routed_experts": 160, "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 128, "num_experts_per_tok": 6,
    "num_hidden_layers": 60, "num_key_value_heads": 128, "q_lora_rank": 1536,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 16,
    "scoring_func": "softmax", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 3, "topk_method": "group_limited_greedy", "v_head_dim": 128,
    "vocab_size": 102400}


def test_bench_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_bench_entries_keys_and_names(kind, keys):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and kind in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_bench_metrics_contract():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in set(e2e[m["moves"]].get("workloads", cells))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        reported = [n for n, m in e2e.items()
                    if c in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2, c
        assert any(c in m.get("workloads", cells)
                   for m in SPEC["per_layer"]), c


def test_bench_names_resolve_to_files():
    for c in SPEC["configs"]:
        path = S.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench/")
        cfg = S.load_json(path)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert (S.BENCH / "reference" / f"{cfg['family']}.py").is_file()
        assert (S.BENCH / "roofline" / f"{cfg['family']}.py").is_file()
        assert (S.BENCH / "policies" / f"{c['name']}.vsr").is_file()
    for w in SPEC["workloads"]:
        cell = S.resolve(w["name"])
        assert w["chips"] in (1, 4)
        assert cell.mix["loop"] in ("open", "closed")
        assert {"unanswered", "outcome_wrong", "answer_wrong"} < \
            set(cell.limits) <= {"unanswered", "outcome_wrong",
                                 "answer_wrong", "logit_gap",
                                 "mean_logit_gap"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(S.reader(m["name"])), m["name"]


def test_bench_deepseek_config_is_the_published_one():
    """Every key of the source's config unchanged, except those ``reduced``
    names (the stage's depth)."""
    entry = next(c for c in SPEC["configs"]
                 if c["name"] == "deepseek-v2-stage")
    cfg = S.load_json(S.ROOT / entry["file"])
    assert entry["reduced"] == ["num_hidden_layers"]
    for k, v in DEEPSEEK_V2.items():
        if k in entry["reduced"]:
            assert cfg[k] != v
        else:
            assert cfg[k] == v, k
    assert cfg["num_hidden_layers"] == 8
    assert cfg["published"] == {"num_hidden_layers": 60}


def test_bench_config_files_are_what_the_port_runs():
    """Each file's sizes are the program's registry config for its arch,
    apart from the depth a stage cuts."""
    from repro_torch.configs import get_config
    for c in SPEC["configs"]:
        cfg = S.load_json(S.ROOT / c["file"])
        pm = S.family(cfg).port_model(cfg)
        reg = get_config(pm["arch"])
        for k, v in pm["fields"].items():
            assert getattr(reg, k) == v, (c["name"], k)
        assert sum(n for _, _, n in pm["groups"]) == sum(
            cfg[k] for k in ("num_hidden_layers", "num_layers") if k in cfg)
