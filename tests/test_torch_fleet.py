"""The port's LocalFleet against the JAX LocalFleet on the CPU.

Reduced smollm-360m (GQA) and reduced deepseek-v2 (MLA + MoE, the fleets'
default ``moe_impl``) at float32, the reference's weights bridged into
the port, the JAX side on its XLA decode path.  Both fleets schedule the same
requests the same way (same buckets, chunks, prefix matches, COW copies,
preemptions), so the tokens must be identical — float32 on both sides
differs only in summation order, far below the logit gaps of these
prompts.
"""

import numpy as np
import pytest
import torch

from repro.serving.fleet import LocalFleet as JaxFleet
from repro_torch.bridge import params_from_jax
from repro_torch.serving.fleet import LocalFleet

ARCH = "smollm-360m"
MLA_ARCH = "deepseek-v2-236b"
F32 = {ARCH: {"dtype": "float32"}}
KERNELS = {ARCH: {"dtype": "float32", "attn_impl": "pallas"}}
SHARED = " ".join(f"sys{i}" for i in range(20))
# test_disagg.py's prompts (more than the 2 slots), plus a 56-word prompt
# that a 16-token prefill chunk splits into four calls
PROMPTS = [SHARED + " question one", "a lone unshared prompt",
           SHARED + " question two with a longer tail of words", "tiny",
           " ".join(f"w{i}" for i in range(56))]


def _pair(arch=ARCH, **kw):
    f32 = {arch: {"dtype": "float32"}}
    jf = JaxFleet([arch], batch=2, gen_tokens=6, paged=True, warmup=False,
                  decode_impl="xla", arch_overrides=f32, **kw)
    tf = LocalFleet([arch], batch=2, gen_tokens=6, warmup=False,
                    arch_overrides=f32, device="cpu", **kw)
    tf.members[arch].params.load_state_dict(
        params_from_jax(jf.members[arch].params))
    return jf, tf


@pytest.fixture(scope="module")
def default_pair():
    """One JAX/port fleet pair for the tests of the default knobs; both
    sides see the same request history, so the shared prefix cache stays
    identical too."""
    return _pair()


@pytest.mark.parametrize("chunk", [None, 16])
def test_fleet_tokens_match_jax(chunk, default_pair):
    jf, tf = default_pair if chunk is None else _pair(prefill_chunk=chunk)
    a = jf.generate(ARCH, PROMPTS)
    b = tf.generate(ARCH, PROMPTS)
    assert [x["tokens"] for x in b] == [x["tokens"] for x in a]
    sched = tf.schedulers[ARCH]
    assert sched.pool.live_refs() == 0
    assert sched.cached_tokens == jf.schedulers[ARCH].cached_tokens > 0
    assert sched.prefill.prefills == jf.schedulers[ARCH].prefill.prefills


def test_kernel_options_equal_plain_tokens_on_cpu():
    """decode_impl="flash_paged" + attn_impl="pallas" (the CUDA kernels'
    options; their plain versions on the CPU) give the plain path's
    tokens exactly."""
    plain = LocalFleet([ARCH], batch=2, gen_tokens=6, warmup=False,
                       arch_overrides=F32, device="cpu")
    kern = LocalFleet([ARCH], batch=2, gen_tokens=6, warmup=False,
                      decode_impl="flash_paged", arch_overrides=KERNELS,
                      device="cpu")
    a = [x["tokens"] for x in plain.generate(ARCH, PROMPTS)]
    b = [x["tokens"] for x in kern.generate(ARCH, PROMPTS)]
    assert a == b


def _payloads():
    shared = " ".join(f"policy{i}" for i in range(32))
    sys_msg = {"role": "system", "content": shared}
    out = []
    for i in range(6):
        msgs = [sys_msg] if i == 3 else \
            ([sys_msg] if i % 2 == 0 else []) + \
            [{"role": "user", "content": f"request number {i} asks a thing"}]
        out.append({"model": "m", "messages": msgs})
    return out


def test_batch_call_prefix_hit_and_cow_match_jax(default_pair):
    """Router transport over both fleets: shared 32-word system prompts
    hit the prefix cache, the prompt that is only the shared blocks is
    fully cached and copies a block (COW) — answers are identical."""
    jf, tf = default_pair
    reqs = _payloads()
    a = jf.call_fn({"m": ARCH}).batch_call(None, reqs, [{}] * len(reqs))
    b = tf.call_fn({"m": ARCH}).batch_call(None, reqs, [{}] * len(reqs))
    for x, y in zip(a, b):
        assert y["choices"][0]["message"]["content"] == \
            x["choices"][0]["message"]["content"]
        assert y["usage"]["completion_tokens"] == \
            x["usage"]["completion_tokens"] == 6
    stats = tf.schedulers[ARCH].pool.stats
    assert stats.cached_tokens > 0 and stats.cow_copies > 0
    assert stats.as_dict() == jf.schedulers[ARCH].pool.stats.as_dict()
    assert tf.schedulers[ARCH].pool.live_refs() == 0


def test_preemption_park_resume_matches_jax():
    """QoS: a high-priority arrival parks a running row when the pool is
    full; the parked row resumes through a prefix-matched admission.  The
    port preempts the same row and every token equals the reference's."""
    outs = []
    for fleet in _pair(max_seq=64, kv_blocks=8):
        sched = fleet.schedulers[ARCH]
        sched.submit(np.arange(4, 44, dtype=np.int32), max_new=6)
        sched.submit(np.arange(50, 90, dtype=np.int32), max_new=6)
        sched.step()
        sched.submit(np.arange(100, 157, dtype=np.int32), max_new=6,
                     priority=10)
        done = {s.rid: list(s.out) for s in sched.drain()}
        assert sched.preempted == 1 and sched.pool.live_refs() == 0
        outs.append(done)
    assert outs[0] == outs[1]


def test_warmup_runs_every_step_and_resets_stats():
    f = LocalFleet([ARCH], batch=2, gen_tokens=4, device="cpu")
    sched = f.schedulers[ARCH]
    assert f.members[ARCH].warmup_ms > 0
    assert sched.decode_steps == 0 and sched.pool.stats.cow_copies == 0
    assert f.members[ARCH].tokens_out == 0
    assert len(f.generate(ARCH, ["hello there"])[0]["tokens"]) == 4
    assert f.remove_member(ARCH) and ARCH not in f.lanes


def test_unported_keywords_and_device_rule(monkeypatch):
    kw = dict(batch=2, warmup=False, device="cpu")
    # speculative decoding is ported: only a malformed config raises
    with pytest.raises(ValueError, match="SpecConfig"):
        LocalFleet([ARCH], speculative=object(), **kw)
    with pytest.raises(NotImplementedError):
        LocalFleet([ARCH], model_axis=2, **kw)
    # the contiguous cache is ported: paged=False serves from slot rows
    contig = LocalFleet([ARCH], paged=False, **kw)
    assert not contig.members[ARCH].paged
    with pytest.raises(NotImplementedError):
        LocalFleet([ARCH], decode_impl="shardmap", **kw)
    with pytest.raises(ValueError, match="unknown decode_impl"):
        LocalFleet([ARCH], decode_impl="bogus", **kw)
    with pytest.raises(ValueError, match="unknown ModelConfig field"):
        LocalFleet([ARCH], arch_overrides={ARCH: {"d_modle": 8}}, **kw)
    with pytest.raises(KeyError):
        LocalFleet(["no-such-arch"], **kw)
    # the training configs are registered and serve like the rest
    llama = LocalFleet(["llama3.2-1b"], gen_tokens=2, **kw)
    assert len(llama.generate("llama3.2-1b", ["hi"])[0]["tokens"]) == 2
    # jamba (SSM state) is registered; it cannot page
    with pytest.raises(ValueError, match="paged KV unsupported"):
        LocalFleet(["jamba-v0.1-52b"], paged=True, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalFleet([ARCH], batch=2, warmup=False)


# ---------------------------------------------------------------------------
# reduced deepseek-v2: MLA + MoE (dropless: capacity factor E/k)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 16])
def test_mla_fleet_tokens_match_jax(chunk):
    """Shared-prefix prompts (suffix prefill over the gathered view, in the
    expanded form), more prompts than slots, and a 16-token chunked
    variant: identical tokens, the same cache hits and prefill calls."""
    jf, tf = _pair(MLA_ARCH, prefill_chunk=chunk)
    a = jf.generate(MLA_ARCH, PROMPTS)
    b = tf.generate(MLA_ARCH, PROMPTS)
    assert [x["tokens"] for x in b] == [x["tokens"] for x in a]
    sched = tf.schedulers[MLA_ARCH]
    assert sched.pool.live_refs() == 0
    assert sched.cached_tokens == jf.schedulers[MLA_ARCH].cached_tokens > 0
    assert sched.prefill.prefills == jf.schedulers[MLA_ARCH].prefill.prefills
    cfg = tf.members[MLA_ARCH].cfg
    assert cfg.moe_capacity_factor == cfg.n_experts / cfg.moe_top_k


def test_mla_preemption_park_resume_matches_jax():
    outs = []
    for fleet in _pair(MLA_ARCH, max_seq=64, kv_blocks=8):
        sched = fleet.schedulers[MLA_ARCH]
        sched.submit(np.arange(4, 44, dtype=np.int32), max_new=6)
        sched.submit(np.arange(50, 90, dtype=np.int32), max_new=6)
        sched.step()
        sched.submit(np.arange(100, 157, dtype=np.int32), max_new=6,
                     priority=10)
        done = {s.rid: list(s.out) for s in sched.drain()}
        assert sched.preempted == 1 and sched.pool.live_refs() == 0
        outs.append(done)
    assert outs[0] == outs[1]


def test_mla_kernel_option_equals_plain_tokens_on_cpu():
    kw = dict(batch=2, gen_tokens=6, warmup=False, device="cpu",
              arch_overrides={MLA_ARCH: {"dtype": "float32"}})
    plain = LocalFleet([MLA_ARCH], **kw)
    kern = LocalFleet([MLA_ARCH], decode_impl="flash_paged", **kw)
    a = [x["tokens"] for x in plain.generate(MLA_ARCH, PROMPTS)]
    b = [x["tokens"] for x in kern.generate(MLA_ARCH, PROMPTS)]
    assert a == b


def test_mla_fleet_moe_impl_rule():
    """Every moe_impl of the reference serves ("gshard", the capacity
    dispatch, ported with training); an unknown one raises."""
    kw = dict(batch=2, warmup=False, device="cpu")
    g = LocalFleet([MLA_ARCH], moe_impl="gshard", gen_tokens=3, **kw)
    assert len(g.generate(MLA_ARCH, ["hello there"])[0]["tokens"]) == 3
    with pytest.raises(ValueError, match="unknown moe impl"):
        LocalFleet([MLA_ARCH], moe_impl="bogus", **kw)
    f = LocalFleet([MLA_ARCH], moe_impl="ep_serve", gen_tokens=3, **kw)
    assert len(f.generate(MLA_ARCH, ["hello there"])[0]["tokens"]) == 3
