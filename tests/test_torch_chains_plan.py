"""Kernel G's launch plans and kernel E's single-block route, on the CPU (no
JAX, no card).

Kernel G (csrc/lstm_scan_bwd_chains.cu `lstm_scan_bwd_chains`) is kernel D's
thread-block cluster whose compute warps each carry 2 or 4 independent
accumulator chains; where no cluster holds H it runs its single block
(csrc/lstm_scan_bwd.cu `lstm_scan_bwd_chains_block`). ops.lstm.plan_chains_
scan weighs both from the shared memory of each layout, the warps of a CTA,
the card's occupancy (faked here as an H100 SXM gives it: 15 clusters of 8
or 7 of 16 for one CTA an SM) and a step model fitted on the card. Kernel
E's single block (csrc/lstm_scan_unrolled_block.cu) takes H above what its
cluster holds, with as many rows a block as fit. Kernel D's single block
keeps dc in registers, so it holds H up to 1024.
"""
import re

import numpy as np
import pytest
import torch

from generative_audio_torch.ops import _cuda
from generative_audio_torch.ops import lstm as tl
from torch_stream_stubs import stream_weight_rows, stub_stream_plans

torch.set_num_threads(2)
SOURCE = "lstm_scan_bwd_chains.cu"


def h100_clusters(cluster, rows, resident=False, arrangement=0):
    """cudaOccupancyMaxActiveClusters of an H100 SXM for one CTA an SM."""
    return 15 if cluster == 8 else 7


def _c_body(source, signature):
    """The return expression of a small C function of csrc/<source> as a
    Python expression: casts, sizeof, integer division and ternaries
    rewritten."""
    text = (_cuda.CSRC / source).read_text()
    body = re.search(re.escape(signature) + r"\s*\{(.*?)\n\}", text,
                     re.S).group(1)
    expr = " ".join(body[body.rindex("return") + len("return"):].split())
    expr = expr.rstrip(";")
    expr = re.sub(r"\(size_t\)", "", expr)
    expr = expr.replace("sizeof(__nv_bfloat16)", "2")
    expr = expr.replace("sizeof(float)", "4").replace("/", "//")
    expr = re.sub(r"\(([^()?]+?) \? ([^()]+?) : ([^()]+?)\)",
                  r"((\2) if (\1) else (\3))", expr)
    return expr.replace("==", " == ").replace("  ", " ")


def _source_smem(source, signature, hsz, cluster, rows, resident):
    stride = _c_body(source, "__host__ __device__ inline int "
                             "slice_stride(int U)")
    smem = _c_body(source, signature)
    env = dict(U=hsz // cluster, hs=hsz + 8, gs=4 * hsz + 8, r=rows, R=rows,
               C=cluster, H=hsz, resident=resident, PAD=8)
    env["slice_stride"] = lambda u: eval(stride, {}, dict(U=u))
    return eval(smem, {}, env)


LAYOUTS = [(384, 8, 16, False), (384, 16, 16, True), (384, 16, 32, False),
           (512, 16, 16, False), (256, 8, 48, False), (64, 8, 32, True)]


@pytest.mark.parametrize("hsz,cluster,rows,resident", LAYOUTS)
def test_cluster_smem_is_the_source_layout(hsz, cluster, rows, resident):
    """Kernel G's CTA has kernel D's layout: the formula of both sources and
    the planner's agree."""
    got = tl.chains_cluster_smem_bytes(hsz, cluster, rows, resident)
    assert got == _source_smem(SOURCE, "size_t chains_cluster_smem(int H, "
                               "int C, int R, bool resident)", hsz, cluster,
                               rows, resident)
    assert got == _source_smem("lstm_scan_bwd.cu", "size_t bwd_cluster_smem("
                               "int H, int C, int R, bool resident)", hsz,
                               cluster, rows, resident)
    assert got == tl.bwd_smem_bytes_cluster(hsz, cluster, rows, resident)


@pytest.mark.parametrize("tiles,groups", [(1, 6), (2, 3), (1, 3), (1, 4),
                                          (3, 4), (4, 1)])
@pytest.mark.parametrize("n_chains", [2, 4])
@pytest.mark.parametrize("arrangement", [0, 1])
def test_compute_warps_are_the_source_s(tiles, groups, n_chains,
                                        arrangement):
    """The compute warps of a CTA (csrc `compute_warps`) and the most chains
    a warp carries: row tiles of one unit group (0) or unit groups of one
    row tile (1)."""
    expr = _c_body(SOURCE, "__host__ __device__ inline int compute_warps("
                           "int mt, int g, int N,\n"
                           "                                             "
                           "int arrange)")
    expr = expr.replace("arrange == ARRANGE_ROWS", "arrange == 0")
    expr = re.sub(r"(.+?) \? (.+?) : (.+)", r"(\2) if (\1) else (\3)", expr)
    warps, chains = tl.chain_warps(tiles, groups, n_chains, arrangement)
    assert warps == eval(expr, {}, dict(mt=tiles, g=groups, N=n_chains,
                                        arrange=arrangement))
    along = tiles if arrangement == 0 else groups
    assert chains == min(n_chains, along)
    assert warps == -(-along // n_chains) * (tiles * groups // along)


def test_cta_warps_are_the_source_s():
    text = (_cuda.CSRC / SOURCE).read_text()
    body = re.search(r"constexpr int chain_cta_warps\(int N\) \{\s*return "
                     r"N == 2 \? (\d+) : (\d+);", text)
    assert (tl.chain_cta_warps(2), tl.chain_cta_warps(4)) == tuple(
        int(x) for x in body.groups()) == (12, 8)


@pytest.mark.parametrize("hsz,n_chains", [(16, 2), (112, 4), (384, 2),
                                          (512, 2), (256, 4), (1024, 1)])
def test_block_smem_is_the_source_layout(hsz, n_chains):
    """The single block (kernel D's, and kernel G's with n chains) with dc
    in registers: h_prev, the dgates tile and dh a 16-row chain, and the
    largest H whose dc a warp's registers hold (8 warps x 16 / n groups of
    8 units)."""
    expr = _c_body("lstm_scan_bwd.cu", "size_t block_smem(int H)")
    assert tl.bwd_smem_bytes(hsz, n_chains) == n_chains * eval(
        expr, {}, dict(H=hsz, ROWS=16, PAD=8)) <= tl.SMEM_LIMIT
    text = (_cuda.CSRC / "lstm_scan_bwd.cu").read_text()
    assert "return 16 / CHAINS;" in text
    assert "H <= 8 * NWARPS * block_groups<CHAINS>()" in text
    assert hsz <= 8 * 8 * 16 // n_chains


# (H, rows, n_chains) -> (C, R, resident, arrangement, waves) by the model
# fitted to the sweep (C = 1: the single block, rows = 16 n)
PLANS = {(384, 2304, 2): (8, 16, False, 1, 10),
         (384, 2304, 4): (8, 16, False, 1, 10),
         (384, 2560, 2): (8, 16, False, 1, 11),
         (384, 2560, 4): (8, 16, False, 1, 11),
         (384, 18, 2): (16, 16, True, 1, 1),
         (384, 18, 4): (8, 16, False, 1, 1),
         (512, 18, 2): (16, 16, False, 1, 1),
         (512, 18, 4): (16, 16, False, 1, 1),
         (512, 2304, 2): (1, 32, False, 0, 1),
         (512, 2304, 4): (16, 16, False, 1, 21),
         (512, 2560, 2): (1, 32, False, 0, 1),
         (512, 2560, 4): (16, 16, False, 1, 23)}


@pytest.mark.parametrize("hsz,batch,n_chains", sorted(PLANS))
def test_plan_at_the_shapes(hsz, batch, n_chains):
    plan = tl.plan_chains_scan(hsz, batch, n_chains, h100_clusters)
    assert (plan.cluster, plan.rows, plan.resident, plan.arrangement,
            plan.waves) == PLANS[hsz, batch, n_chains]
    assert plan.chains == n_chains and plan.smem_bytes <= tl.SMEM_LIMIT
    if plan.design == "cluster":
        tiles, groups = plan.rows // 16, hsz // plan.cluster // 8
        warps, chains = tl.chain_warps(tiles, groups, n_chains,
                                       plan.arrangement)
        assert chains == n_chains            # never fewer chains than asked
        assert warps + tiles * groups <= tl.chain_cta_warps(n_chains)
        assert plan.smem_bytes == tl.chains_cluster_smem_bytes(
            hsz, plan.cluster, plan.rows, plan.resident)
        assert plan.clusters == -(-batch // plan.rows)
        assert plan.active == h100_clusters(plan.cluster, plan.rows)
        assert plan.step_us == tl.chains_step_us(
            hsz, plan.cluster, plan.rows, plan.resident, n_chains)
        assert plan.launch_args == (plan.cluster, plan.rows,
                                    int(plan.resident), plan.arrangement,
                                    plan.smem_bytes)
    else:
        assert plan.smem_bytes == tl.bwd_smem_bytes(hsz, n_chains)
        assert plan.clusters == -(-batch // (16 * n_chains))
        assert plan.launch_args == (plan.smem_bytes,)
    assert plan.waves == -(-plan.clusters // plan.active)


# one-cluster steps (us) of kernel G measured on an H100 SXM at 700 W, T=195
# (generative_audio_torch/scripts/perf_lstm_chains.py --sweep):
# (H, C, R, resident, n_chains)
MEASURED_STEPS = {(384, 8, 16, False, 2): 9.81, (384, 16, 16, True, 2): 9.22,
                  (384, 16, 32, False, 2): 17.62, (384, 16, 16, False, 2): 9.11,
                  (384, 8, 16, False, 4): 13.36, (512, 16, 16, False, 2): 11.31,
                  (512, 16, 16, False, 4): 14.99}


def test_step_model_fits_the_sweep():
    for layout, us in MEASURED_STEPS.items():
        assert tl.chains_step_us(*layout) == pytest.approx(us, abs=0.7)
    # a further chain costs a warp more than it saves
    assert tl.chains_step_us(384, 8, 16, False, 2) > tl.bwd_step_us(
        384, 8, 16, False)


@pytest.mark.parametrize("hsz,n_chains,need", [
    (528, 2, "single block: 237568 B"), (640, 2, "single block: 287744 B"),
    (272, 4, "single block: 245760 B")])
def test_refuses_where_no_design_holds_the_chains(hsz, n_chains, need):
    """Above H=512 no cluster holds kernel D's slices and no single block
    two chains; four chains fit neither above H=256 unless a cluster takes
    H. Kernel G raises with the bytes and never runs fewer chains."""
    with pytest.raises(ValueError, match=need):
        tl.plan_chains_scan(hsz, 40, n_chains, h100_clusters)


def _operands(t, b, h, seed):
    rng = np.random.default_rng(seed)

    def bf16(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(torch.bfloat16)

    return (bf16((t, b, 4 * h), 1.0), bf16((t, b, h), 0.5),
            bf16((t, b, h), 0.5), bf16((t, b, h), 1.0),
            torch.from_numpy((rng.standard_normal((h, 4 * h)) * 0.1).astype(
                np.float32)))


@pytest.fixture
def entries(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors with the raw launch faked
    (records the entry and its arguments, launches nothing) and kernel G's
    plans from an H100's occupancy."""
    calls, asked = [], []

    def card_plan(device, hsz, batch, n_chains):
        asked.append((hsz, batch, n_chains))
        return tl.plan_chains_scan(hsz, batch, n_chains, h100_clusters)

    monkeypatch.setattr(tl, "_is_cuda", lambda *tensors: True)
    monkeypatch.setattr(tl, "card_chains_scan_plan", card_plan)
    monkeypatch.setattr(tl, "_launch_kernel",
                        lambda name, *args: calls.append((name, args)))
    return calls, asked


def _zero_units(x, n, hsz):
    """The units hsz.. of each of the n gate blocks of x [..., n hp]."""
    return x.unflatten(-1, (n, x.shape[-1] // n))[..., hsz:]


@pytest.mark.parametrize("hsz,n_chains,entry,hp", [
    (384, 2, "lstm_scan_bwd_chains", 384),
    (384, 4, "lstm_scan_bwd_chains", 384),
    (512, 4, "lstm_scan_bwd_chains", 512),
    (20, 2, "lstm_scan_bwd_chains_block", 32),
    (100, 4, "lstm_scan_bwd_chains_block", 112)])
def test_wrapper_hands_the_entry_its_plan(entries, hsz, n_chains, entry, hp):
    """lstm_scan_bwd_tm(..., n_chains) asks for kernel G's plan at H padded
    to 16 and launches the plan's entry: the cluster with W_hh [H, 4H] and
    W_hh^T in fragment order and the plan's five arguments, or the single
    block with both W_hh layouts and its shared bytes. H is zero-padded
    (zero units in every operand) and the result sliced back."""
    calls, asked = entries
    ops = _operands(3, 18, hsz, seed=1)
    out = tl.lstm_scan_bwd_tm(*ops, n_chains=n_chains)
    assert tuple(out.shape) == (3, 18, 4 * hsz) and asked == [(hp, 18, n_chains)]
    plan = tl.plan_chains_scan(hp, 18, n_chains, h100_clusters)
    (name, args), = calls
    assert name == entry
    gates, h_seq, c_seq, gout = args[:4]
    assert tuple(gates.shape) == (3, 18, 4 * hp)
    assert all(tuple(x.shape) == (3, 18, hp) for x in (h_seq, c_seq, gout))
    for x, n in ((gates, 4), (h_seq, 1), (c_seq, 1), (gout, 1)):
        assert not _zero_units(x, n, hsz).any()
    if entry == "lstm_scan_bwd_chains":
        w, wf = args[4], args[5]
        assert tuple(w.shape) == (hp, 4 * hp)
        assert torch.equal(wf, tl._fragment_weight(w.t().contiguous()))
        assert args[7:] == (3, 18, hp, n_chains, *plan.launch_args)
    else:
        wt, w = args[4], args[5]
        assert torch.equal(wt.t(), w) and tuple(w.shape) == (hp, 4 * hp)
        assert args[7:] == (3, 18, hp, n_chains,
                            tl.bwd_smem_bytes(hp, n_chains))
        assert plan.design == "block"
    assert not w[hsz:].any() and not _zero_units(w, 4, hsz).any()


def test_planned_wrapper_launches_the_given_chains_plan(entries):
    """lstm_scan_bwd_planned_tm runs a ChainsPlan's chains and design, asking
    the card for nothing."""
    calls, asked = entries
    ops = _operands(2, 40, 384, seed=2)
    for plan in (tl.plan_chains_scan(384, 40, 2, h100_clusters),
                 tl.plan_chains_scan(384, 40, 2, lambda *a: 0)):
        tl.lstm_scan_bwd_planned_tm(*ops, plan)
    assert asked == []
    assert [name for name, _ in calls] == ["lstm_scan_bwd_chains",
                                           "lstm_scan_bwd_chains_block"]
    assert calls[0][1][-5:] == tl.plan_chains_scan(
        384, 40, 2, h100_clusters).launch_args
    assert calls[1][1][-2:] == (2, tl.bwd_smem_bytes(384, 2))


def test_cpu_branch_is_the_plain_version():
    ops = _operands(4, 5, 20, seed=3)
    for n in tl.CHAIN_COUNTS:
        assert torch.equal(tl.lstm_scan_bwd_tm(*ops, n_chains=n),
                           tl.lstm_scan_bwd_reference_tm(*ops))


def test_sources_declare_their_entries():
    """The entries of kernel G's two sources and of kernel E's single block
    take what ops/_cuda.py declares, the cluster's ending in its plan and
    the stream; each library has its error string and kernel G its
    occupancy query."""
    cases = {"lstm_scan_bwd_chains": ["lstm_scan_bwd_chains"],
             "lstm_scan_bwd": ["lstm_scan_bwd_chains_block"],
             "lstm_scan_unrolled_block": ["lstm_scan_fwd_unrolled_block"]}
    for source, names in cases.items():
        text = (_cuda.CSRC / f"{source}.cu").read_text()
        assert f"{source}_error_string" in text
        for name in names:
            params = re.search(rf"\bint {name}\(([^)]*)\)", text).group(1)
            names_ = [p.split()[-1].lstrip("*") for p in params.split(",")]
            assert len(names_) == len(_cuda._SIGNATURES[source][name]), name
            assert names_[-1] == "stream" and names_[-2] == "smem_bytes"
    text = (_cuda.CSRC / f"{SOURCE}").read_text()
    params = re.search(r"\bint lstm_scan_bwd_chains\(([^)]*)\)", text).group(1)
    assert [p.split()[-1] for p in params.split(",")][-7:] == [
        "n_chains", "cluster", "rows", "resident", "arrange", "smem_bytes",
        "stream"]
    query = re.search(r"\bint lstm_scan_bwd_chains_max_clusters\(([^)]*)\)",
                      text).group(1)
    assert " ".join(query.split()) == ("int n_chains, int arrange, int "
                                      "resident, int H, int cluster, int "
                                      "rows, int* n")
    assert len(_cuda._QUERIES["lstm_scan_bwd_chains"][
        "lstm_scan_bwd_chains_max_clusters"]) == 7
    assert tl._SOURCE_OF["lstm_scan_bwd_chains"] == "lstm_scan_bwd_chains"
    assert tl._SOURCE_OF["lstm_scan_bwd_chains_block"] == "lstm_scan_bwd"
    assert tl._SOURCE_OF["lstm_scan_fwd_unrolled_block"] == \
        "lstm_scan_unrolled_block"


@pytest.mark.parametrize("hsz,rows,k", [(640, 8, 2), (640, 8, 4),
                                        (768, 4, 4), (1024, 8, 2),
                                        (1104, 4, 4)])
def test_unrolled_block_smem_is_the_source_layout(hsz, rows, k):
    """Kernel E's single block: two h tiles, c and k steps of gates for its
    rows; the most rows of (16, 8, 4) that fit."""
    expr = _c_body("lstm_scan_unrolled_block.cu",
                   "size_t unrolled_block_smem(int H, int RB, int K)")
    got = tl.unrolled_block_smem_bytes(hsz, rows, k)
    assert got == eval(expr, {}, dict(H=hsz, RB=rows, K=k, ROWS=16, PAD=8))
    assert tl.unrolled_block_rows(hsz, k) == rows
    assert got <= tl.SMEM_LIMIT
    bigger = [r for r in tl.UNROLLED_BLOCK_ROWS if r > rows]
    assert all(tl.unrolled_block_smem_bytes(hsz, r, k) > tl.SMEM_LIMIT
               for r in bigger)


@pytest.mark.parametrize("hsz,route", [(512, (512, "")), (520, (528, "_block")),
                                       (600, (608, "_block")),
                                       (768, (768, "_block"))])
def test_unrolled_wrapper_takes_the_block_above_the_cluster(entries, hsz,
                                                            route,
                                                            monkeypatch):
    """Kernel E takes its cluster up to H=512 (padded to its units); above
    it its streamed cluster (padded to stream_hidden's units, handing the
    entry the plan it packed W_hh^T for) and, within
    single_block_forwards(), its single block (padded to 16, handing the
    entry its rows a block and shared bytes), with zero units in the gates
    and W_hh^T."""
    calls, _ = entries
    stub_stream_plans(monkeypatch)
    gates = torch.zeros(4, 9, 4 * hsz, dtype=torch.bfloat16).normal_()
    w_hh = torch.zeros(hsz, 4 * hsz).normal_(std=0.02)
    if route[1]:
        with torch.no_grad():
            out = tl.lstm_scan_tm(gates, w_hh, block_t=4)
        (name, args), = calls
        hp, suffix, plan = tl.unrolled_route(hsz, 4, 9, torch.device("cpu"))
        assert name == "lstm_scan_fwd_unrolled_stream" and suffix == "_stream"
        assert hp == tl.stream_hidden(hsz, plan.cluster)
        assert args[3:] == (4, 9, hp, 4, *plan.launch_args)
        assert not _zero_units(args[0], 4, hsz).any()
        wt = stream_weight_rows(args[1], plan, 4)
        assert not wt[:, hsz:].any() and not _zero_units(wt.t(), 4, hsz).any()
        assert tuple(out.shape) == (4, 9, hsz)
        calls.clear()
        with tl.single_block_forwards():
            assert tl.unrolled_route(hsz, 4) == (*route, None)
            with torch.no_grad():
                out = tl.lstm_scan_tm(gates, w_hh, block_t=4)
        (name, args), = calls
        hp = route[0]
        rows = tl.unrolled_block_rows(hp, 4)
        assert name == "lstm_scan_fwd_unrolled_block"
        assert args[3:] == (4, 9, hp, 4, rows,
                            tl.unrolled_block_smem_bytes(hp, rows, 4))
        assert not _zero_units(args[0], 4, hsz).any()
        assert tuple(args[1].shape) == (4 * hp, hp) and not args[1][:, hsz:].any()
        assert tuple(out.shape) == (4, 9, hsz)
        # a cluster plan is for an H that a cluster holds
        with pytest.raises(ValueError, match="no cluster of kernel E"):
            tl.lstm_scan_unrolled_planned_tm(
                gates, w_hh, tl.plan_unrolled(512, 9, 4, h100_clusters), 4)
    else:
        assert tl.unrolled_route(hsz, 4) == (*route, None)
        assert tl.unrolled_smem_bytes(hsz, 16, 16, 4) <= tl.SMEM_LIMIT
