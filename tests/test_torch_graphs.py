"""Port parity: the programs layer (paddle_tpu_torch/jit/graphs.py) on the
CPU, where every program runs its body eagerly on its static inputs.

- Program keys against the reference: on the same traffic (decode chunks
  near capacity, ``spec_k=3``, constrained and adapter rows, both
  layouts), the engine's program keys name the reference engine's jit
  caches: the effective chunks of ``_decode_jit``, whether ``_verify_jit``
  exists, and the chunk and bucket keys of ``_prefill_jit``.  The same
  runs give the reference's tokens (greedy rows, and sampled rows at
  top_k=1, whose one survivor is the argmax in both frameworks).
- The staged bodies against the unstaged computation: a decode tick and a
  verify through their programs (the token mask always an input, the LoRA
  rows a tensor, knobs and tables staged through the packed buffer) draw
  the same sampled tokens, bit for bit, as ``generate_step`` +
  ``sample_rows`` / ``verify_step`` + ``spec_accept`` called directly from
  the same generator state; a chunk's logits at a device index equal
  those at the int.
- generate()'s step program: a second call of the same signature reuses
  the program and its static cache and still gives the reference's
  tokens (static, int8, paged with a shared prefix, constrained, an
  adapter); a fresh generator a call reuses it too and draws what the
  same seed drew; another signature replaces it.
- ``disable_graphs()`` leaves CPU results unchanged, and the layer
  imports neither JAX nor the reference package.
The reference's Pallas kernels run in interpret mode.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import LLMEngine as JEngine
from paddle_tpu.inference import constrain as jcon
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import lora as jlora
from paddle_tpu_torch.convert import load_reference_state
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.inference import constrain as tcon
from paddle_tpu_torch.jit import Program, Programs, disable_graphs
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import lora as tlora
from paddle_tpu_torch.models.generation import free_programs
from paddle_tpu_torch.ops import lora as tolora
from paddle_tpu_torch.ops.sampling import sample_rows, spec_accept

V = 1024
EOS = V - 1
DIMS = dict(num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=256,
            use_flash_attention=False)
PAGED = dict(kv_layout="paged", page_size=32, prefill_chunk=32)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(23)
    jm = JLlama(JConfig.tiny(tensor_parallel=False, **DIMS))
    jm.eval()
    tm = load_reference_state(LlamaForCausalLM(LlamaConfig.tiny(**DIMS), device="cpu"),
                              {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm.eval()


@pytest.fixture(scope="module")
def vocab():
    v = [str(i) if i < 10 else f"w{i}" for i in range(V)]
    v[EOS] = "</s>"
    return v


def _adapters(mod, model):
    sites = mod.lora_sites(model)
    return {f"a{i}": mod.LoraAdapter.random(sites, rank=4, seed=300 + i) for i in range(2)}


def _keys(eng):
    """The port's program keys, named as the reference's jit caches."""
    keys = eng.programs.keys()
    prefill = set()
    for k in keys:
        if k[0] == "chunk":
            prefill.add("chunk")
        elif k[0] == "bucket":
            prefill |= {k[1], ("w", k[1])}
    return ({k[1] for k in keys if k[0] == "decode"}, any(k[0] == "verify" for k in keys),
            prefill)


def _jkeys(jeng):
    return set(jeng._decode_jit), jeng._verify_jit is not None, set(jeng._prefill_jit)


# (engine kwargs, prompt lengths, new tokens, per-request submit kwargs)
KEY_RUNS = {
    # 110- and 105-token prompts at L = 128 with 2 steps a tick: the
    # effective chunk shrinks to 1 at capacity; a sampled row at top_k=1
    "dense_chunk2_near_capacity": (dict(max_seq_len=128, decode_chunk=2), (110, 105), 24,
                                   [dict(do_sample=True, top_k=1), {}]),
    # a verify a tick until fewer than 3 rows of headroom remain
    "dense_spec3": (dict(max_seq_len=128, spec_k=3), (112,), 20, [{}]),
    # adapter rows, a constrained row and a base row, 2 steps a tick but
    # one while the constrained row decodes; pages of 32, chunks of 32
    "paged_chunk2_adapters_constrained": (
        dict(PAGED, max_seq_len=128, decode_chunk=2, eos_token_id=EOS), (100, 40, 95), 30,
        [dict(adapter_id="a0"), dict(constraint=r"[0-9][0-9][0-9]"), dict(adapter_id="a1")]),
    # the prefix cache on: the second prompt shares the first's 64 tokens
    "paged_spec3_prefix": (dict(PAGED, max_seq_len=128, spec_k=3), (70, 70), 16,
                           [{}, dict(do_sample=True, top_k=1)]),
}


def _traffic(run):
    kw, lens, n_new, per_req = KEY_RUNS[run]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, EOS, n).astype(np.int32) for n in lens]
    if run == "paged_spec3_prefix":
        prompts[1][:64] = prompts[0][:64]
    return kw, prompts, n_new, per_req


def _serve(eng, prompts, n_new, per_req):
    futs = [eng.submit(p, max_new_tokens=n_new, **kw) for p, kw in zip(prompts, per_req)]
    eng.run_until_complete()
    return [f.result(timeout=1) for f in futs]


@pytest.mark.parametrize("run", sorted(KEY_RUNS))
def test_program_keys_and_tokens_equal_reference(pair, vocab, run):
    jm, tm = pair
    kw, prompts, n_new, per_req = _traffic(run)
    jkw, tkw = dict(kw), dict(kw)
    if "adapter_id" in str(per_req):
        jkw["adapters"] = jlora.AdapterRegistry.from_adapters(jm, _adapters(jlora, jm), rank=4)
        tkw["adapters"] = tlora.AdapterRegistry.from_adapters(tm, _adapters(tlora, tm), rank=4)
        jkw["constraint_vocab"] = tkw["constraint_vocab"] = vocab
    jeng = JEngine(jm, max_batch_slots=3, **jkw)
    eng = LLMEngine(tm, max_batch_slots=3, **tkw)
    if run != "dense_chunk2_near_capacity":  # there every key is made when first met
        jeng.warmup()
        eng.warmup()
        assert _keys(eng) == _jkeys(jeng)  # what warmup() makes
    want = _serve(jeng, prompts, n_new, per_req)
    got = _serve(eng, prompts, n_new, per_req)
    assert got == want
    assert _keys(eng) == _jkeys(jeng)
    decode = {k[1] for k in eng.programs.keys() if k[0] == "decode"}
    if "chunk2" in run:
        assert len(decode) > 1  # effective chunks past the configured one
    assert eng.programs.captured == []  # the CPU captures nothing


def _busy(tm, n=3, **kw):
    """An engine whose slots all decode, the rows sampled (temperature 0.8,
    top-p 0.9, every second row top_k 5)."""
    eng = LLMEngine(tm, max_batch_slots=n, max_seq_len=128,
                    generator=torch.Generator().manual_seed(4), **kw)
    rng = np.random.RandomState(9)
    for i in range(n):
        eng.submit(rng.randint(1, EOS, 20 + 7 * i).astype(np.int32), max_new_tokens=60,
                   do_sample=True, temperature=0.8, top_p=0.9, top_k=5 * (i % 2),
                   adapter_id=f"a{i % 2}" if kw.get("adapters") else None)
    while not all(r is not None for r in eng.slot_req):
        eng.step()
    return eng


def _unstaged_knobs(eng):
    return tuple(torch.from_numpy(v) for v in eng._knobs(eng.slot_req).values())


@pytest.mark.parametrize("layout", ["dense", "paged", "paged_adapters"])
def test_staged_decode_tick_draws_equal_unstaged(pair, layout):
    _, tm = pair
    kw = {} if layout == "dense" else dict(PAGED)
    if layout == "paged_adapters":
        kw["adapters"] = tlora.AdapterRegistry.from_adapters(tm, _adapters(tlora, tm), rank=4)
    eng = _busy(tm, **kw)
    for _ in range(3):
        tok = eng.last_token.astype(np.int64)[:, None]
        pos = eng.slot_pos.astype(np.int64)
        pt = eng._active_table() if eng.paged else None
        rows = eng._lora_rows(eng.slot_req)
        assert (rows is not None) == (layout == "paged_adapters")
        state = eng._gen.get_state()
        got = eng._decode(tok, pos, eng.slot_req, 1, pt, rows)[:, 0]
        eng._gen.set_state(state)
        p = torch.from_numpy(pos)
        caches = (eng._paged_caches(p, torch.from_numpy(pt)) if eng.paged
                  else eng._dense_caches(p))
        ctx = (tolora.activate(eng.adapters.pool.site_pools(), torch.from_numpy(rows))
               if rows is not None else torch.no_grad())
        with torch.no_grad(), ctx:
            logits, _ = tm.generate_step(torch.from_numpy(tok), caches=caches)
            want = sample_rows(logits[:, -1], eng._gen, *_unstaged_knobs(eng))
        np.testing.assert_array_equal(got, want.numpy())
        eng.step()  # the real tick moves the slots on


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_staged_verify_equals_unstaged(pair, layout):
    _, tm = pair
    eng = _busy(tm, spec_k=3, **({} if layout == "dense" else PAGED))
    rng = np.random.RandomState(2)
    last, pos = eng.last_token.copy(), eng.slot_pos.copy()
    drafts = rng.randint(1, EOS, (3, 3)).astype(np.int32)
    pt = eng._active_table() if eng.paged else None
    state = eng._gen.get_state()
    out, n_acc = eng._verify(last, pos, drafts, eng.slot_req, pt)
    eng._gen.set_state(state)
    p = torch.from_numpy(pos.astype(np.int64))
    caches = eng._paged_caches(p, torch.from_numpy(pt)) if eng.paged else eng._dense_caches(p)
    ids = torch.from_numpy(np.concatenate([last[:, None], drafts], 1).astype(np.int64))
    with torch.no_grad():
        logits, _ = tm.verify_step(ids, caches)
        w_out, w_acc = spec_accept(logits, torch.from_numpy(drafts), eng._gen,
                                   *_unstaged_knobs(eng))
    np.testing.assert_array_equal(out, w_out.numpy())
    np.testing.assert_array_equal(n_acc, w_acc.numpy())


def test_chunk_logits_at_device_index_equal_int(pair):
    _, tm = pair
    eng = LLMEngine(tm, max_batch_slots=1, max_seq_len=128, **PAGED)
    ids = torch.from_numpy(np.random.RandomState(1).randint(1, EOS, (1, 32)))
    pt = torch.arange(1, 5, dtype=torch.int32)[None]
    with torch.no_grad():
        a, _ = tm.prefill_chunk_step(ids, eng._paged_caches(torch.tensor([0]), pt), 20)
        b, _ = tm.prefill_chunk_step(ids, eng._paged_caches(torch.tensor([0]), pt),
                                     torch.tensor([20]))
        c, _ = tm.prefill_step(ids, 7)
        d, _ = tm.prefill_step(ids, torch.tensor([7]))
    assert torch.equal(a, b) and torch.equal(c, d)


GEN_RUNS = {
    "static": {},
    "int8": dict(cache_dtype="int8"),
    "paged_shared_prefix": dict(kv_layout="paged", page_size=16, share_prefix=True),
}


def _jgen(jm, ids, n, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids.astype(np.int32)), max_new_tokens=n,
                                  **kw)._value)


@pytest.mark.parametrize("run", sorted(GEN_RUNS) + ["constrained", "adapter"])
def test_generate_program_reused_equals_reference(pair, vocab, run):
    """Two calls of one signature (different prompts, a fresh constraint
    and a fresh adapter mapping each): one program, its static cache
    written in place by the second call, and each call gives the
    reference's tokens."""
    jm, tm = pair
    rng = np.random.RandomState(3)
    free_programs(tm)
    caches = None
    for _ in range(2):
        kw_t = kw_j = GEN_RUNS.get(run, {})
        if run == "constrained":
            kw_j = dict(token_mask_fn=jcon.compile_constraint(r"w1[0-9]+", vocab, EOS))
            kw_t = dict(token_mask_fn=tcon.compile_constraint(r"w1[0-9]+", vocab, EOS))
        elif run == "adapter":
            kw_j = dict(adapter_id="a1", adapters=_adapters(jlora, jm))
            kw_t = dict(adapter_id="a1", adapters=_adapters(tlora, tm))
        ids = rng.randint(1, EOS, (2, 24))
        if run == "paged_shared_prefix":
            ids[1, :16] = ids[0, :16]
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=4, **kw_t).numpy()
        np.testing.assert_array_equal(got, _jgen(jm, ids, 4, **kw_j))
        (prog,) = [tm._generate_programs.get(k) for k in tm._generate_programs.keys()]
        ptrs = [t.data_ptr() for t in prog.inputs.values()]
        assert caches is None or ptrs == caches
        caches = ptrs


def test_generate_keeps_one_program_keyed_by_signature(pair):
    """A fresh generator on every call reuses the program and draws what the
    same seed drew before, advancing the caller's generator; another
    signature replaces the program; free_programs drops it."""
    _, tm = pair
    ids = torch.from_numpy(np.random.RandomState(4).randint(1, EOS, (2, 20)))
    free_programs(tm)
    outs, states = [], []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        outs.append(tm.generate(ids, max_new_tokens=5, do_sample=True, temperature=0.9,
                                generator=g).numpy())
        states.append(g.get_state())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert torch.equal(states[0], states[1])
    assert not torch.equal(states[0], torch.Generator().manual_seed(11).get_state())
    assert len(tm._generate_programs.keys()) == 1
    with disable_graphs():
        again = tm.generate(ids, max_new_tokens=5, do_sample=True, temperature=0.9,
                            generator=torch.Generator().manual_seed(11)).numpy()
    np.testing.assert_array_equal(again, outs[0])
    tm.generate(ids[:, :12], max_new_tokens=3)
    (key,) = tm._generate_programs.keys()
    assert key[:3] == (2, 12, 3)
    free_programs(tm)
    assert tm._generate_programs.keys() == []


def test_disable_graphs_leaves_cpu_results_unchanged(pair):
    _, tm = pair
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, EOS, n).astype(np.int32) for n in (50, 90)]
    per_req = [dict(do_sample=True, temperature=0.8, top_p=0.9), {}]

    def serve():
        eng = LLMEngine(tm, max_batch_slots=2, max_seq_len=128,
                        generator=torch.Generator().manual_seed(6), **PAGED)
        return _serve(eng, prompts, 12, per_req)

    def gen():
        return tm.generate(torch.from_numpy(rng_ids), max_new_tokens=5, do_sample=True,
                           generator=torch.Generator().manual_seed(2)).numpy()

    rng_ids = rng.randint(1, EOS, (2, 30))
    want, want_gen = serve(), gen()
    with disable_graphs():
        assert serve() == want
        np.testing.assert_array_equal(gen(), want_gen)


def test_program_stages_into_one_packed_buffer():
    """Inputs of mixed dtypes live in one byte buffer, each 16-byte
    aligned; staging writes host values in place and the CPU body reads
    them."""
    owner = Programs("cpu")
    seen = {}

    def body(a, b, m):
        seen.update(a=a.clone(), b=b.clone(), m=m.clone())
        return a.float().sum() + b.sum()

    prog = owner.get("k", lambda: Program(owner, "k", body, dict(
        a=torch.zeros(3, dtype=torch.int64), b=torch.ones(5), m=torch.ones((2, 7), dtype=torch.bool))))
    assert owner.get("k", None) is prog and "k" in owner and owner.keys() == ["k"]
    assert all(t.data_ptr() % 16 == 0 for t in prog.inputs.values())
    prog.stage(a=np.array([1, 2, 3]), b=np.full(5, 0.5, np.float32))
    prog.host_view("m")[1, 3] = False
    assert float(prog()) == 8.5
    assert seen["a"].tolist() == [1, 2, 3] and not seen["m"][1, 3] and seen["m"].sum() == 13
    np.testing.assert_array_equal(prog.fetch(seen["b"]), np.full(5, 0.5, np.float32))
    owner.drop("k")
    assert "k" not in owner


def test_capture_tally_and_kernel_node_names(monkeypatch):
    """A wrapper's launch counts at once, or, while this thread captures
    for a program, goes into the capture's tally; each kernel node name of
    the port's kernels maps to its wrapper, and no other kernel does."""
    from paddle_tpu_torch.jit import graphs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import decode_attention as da

    before = da.paged_attention_kernel.launches
    _build.count(da.paged_attention_kernel)
    assert da.paged_attention_kernel.launches == before + 1
    monkeypatch.setattr(_build, "_capturing", lambda: True)
    _build._capture.tally = {}
    try:
        _build.count(da.paged_attention_kernel)
        _build.count(da.paged_attention_kernel)
        tally = _build._capture.tally
    finally:
        _build._capture.tally = None
    assert tally == {(da.paged_attention_kernel, "launches"): 2}
    assert da.paged_attention_kernel.launches == before + 1
    names = {
        "_ZN12kv_attention16kv_decode_kernelILi128E13__nv_bfloat16S1_Lb1ENS_9PagedRowsEEEv"
        "14CUtensorMap_stS3_NS_6ParamsET3_": "paged_attention_kernel",
        "_ZN12kv_attention15kv_chunk_kernelILi128E6__halfaLb0ENS_10StaticRowsEEEv"
        "14CUtensorMap_stS3_NS_6ParamsET3_": "decode_attention_kernel",
        "_Z16flash_fwd_kernelI13__nv_bfloat16Li128EEv14CUtensorMap_stS1_S1_7FwdArgs":
            "flash_attention_kernel",
        "_Z20encoder_fwd_residentI13__nv_bfloat16Li64ELi4EEv14CUtensorMap_stS1_S1_7FwdArgsIT_E":
            "encoder_attention_kernel",
        "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEEEEviT0_": None,
    }
    assert {n: graphs._wrapper_of(n) for n in names} == names


def test_disable_graphs_is_thread_local():
    import threading

    from paddle_tpu_torch.jit import graphs

    seen = []
    with disable_graphs():
        t = threading.Thread(target=lambda: seen.append(graphs._graphs_enabled()))
        t.start()
        t.join()
        assert not graphs._graphs_enabled()
    assert seen == [True] and graphs._graphs_enabled()


def test_graphs_layer_imports_no_jax_or_reference():
    import paddle_tpu_torch.jit.graphs as g

    tree = ast.parse(Path(g.__file__).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu") for m in mods), mods
