"""Stand-ins for the card around the streamed cluster forwards and
backwards, for the CPU tests that take the wrappers' CUDA branch on CPU
tensors: a stub occupancy in place of the card's, and the unpacking of the
streamed entries' W_hh operands for the fake launches. No JAX."""
import torch

from generative_audio_torch.ops import lstm as tl


def stub_occupancy(hsz, cluster, rows, resident, stages):
    """Clusters an H100 runs at once, as a stand-in for the card's
    cudaOccupancyMaxActiveClusters of a streamed forward: one CTA an SM."""
    return 8 if cluster == 16 else 16


def stub_stream_plans(monkeypatch):
    """The streamed forwards' plans of both modules from stub_occupancy, in
    place of the card's (card_stream_plan; and kernels E's and F's,
    card_unrolled_stream_plan and card_layer_stream_plan), for the
    wrappers' CUDA branch on CPU tensors."""
    from generative_audio_torch.ops import gru as tg
    for module in (tl, tg):
        monkeypatch.setattr(
            module, "card_stream_plan",
            lambda device, hsz, batch, instance=None, resident=None,
            module=module: module.plan_stream_scan(hsz, batch,
                                                   stub_occupancy, resident))
    monkeypatch.setattr(
        tl, "card_unrolled_stream_plan",
        lambda device, hsz, batch, k, resident=None: tl.plan_unrolled_stream(
            hsz, batch, k, lambda h, c, r, res, stages, groups:
            stub_occupancy(h, c, r, res, stages), resident))
    monkeypatch.setattr(
        tl, "card_layer_stream_plan",
        lambda device, hsz, batch, f, out_dtype=torch.bfloat16,
        resident=None: tl.plan_layer_stream(hsz, batch, f, stub_occupancy,
                                            resident))


def stub_wide_occupancy(hsz, cluster, rows, resident, stages):
    """Clusters of the wide forwards an H100 runs at once (one CTA an SM),
    as stub_occupancy."""
    return stub_occupancy(hsz, cluster, rows, resident, stages)


def card_wide_occupancy(hsz, cluster, rows, resident, stages):
    """Clusters of the wide forwards the card runs at once as an H100 SXM
    reports them (cudaOccupancyMaxActiveClusters, one CTA an SM): 15
    clusters of 8 and 7 of 16, as PERF.md's table reads for every design
    of one CTA an SM, where stub_occupancy's 16 and 8 are the SMs over the
    cluster size."""
    return 7 if cluster == 16 else 15


def stub_wide_route(monkeypatch):
    """The plans kernels A and B weigh on a card (card_scan_plan,
    card_wide_plan) from the stub occupancy, and the route weighing them
    for CPU tensors as it does on a card (ops/lstm.py _on_card), for the
    wrappers' CUDA branch on CPU tensors."""
    monkeypatch.setattr(
        tl, "card_scan_plan",
        lambda device, hsz, batch, out_dtype=torch.bfloat16, carry=False,
        train=False: tl.plan_scan(hsz, batch, lambda c, r: stub_occupancy(
            hsz, c, r, 0, 1)))
    monkeypatch.setattr(
        tl, "card_wide_plan",
        lambda device, hsz, batch, resident=None:
        tl.plan_wide_scan(hsz, batch, stub_wide_occupancy, resident))
    monkeypatch.setattr(tl, "_on_card", lambda device: True)


def stub_bwd_plans(monkeypatch):
    """The backward scans' plans of both modules (card_bwd_scan_plan: the
    single block, a resident cluster or the streamed cluster) from
    stub_occupancy, in place of the card's."""
    from generative_audio_torch.ops import gru as tg
    for module in (tl, tg):
        monkeypatch.setattr(
            module, "card_bwd_scan_plan",
            lambda device, hsz, batch, module=module: module.plan_bwd_scan(
                hsz, batch,
                lambda c, r, res: stub_occupancy(hsz, c, r, 0, 1),
                stream_clusters=stub_stream_bwd_occupancy))


def stub_stream_bwd_occupancy(hsz, cluster, rows, resident, stages, tile):
    """Clusters of a streamed backward an H100 runs at once (one CTA an SM),
    as stub_occupancy."""
    return stub_occupancy(hsz, cluster, rows, resident, stages)


def stream_weight_rows(wf, plan, n_gates):
    """The kernel weight W_hh^T [n*hp, hp] from a streamed entry's operand
    (ops/lstm.py _stream_weight undone), after checking its shape against
    the plan it was packed for."""
    hp, cluster = plan.hidden, plan.cluster
    units = hp // cluster
    assert tuple(wf.shape) == (cluster, hp // 32, n_gates * units // 8, 8, 4,
                               2, 2, 2)
    w = wf.permute(0, 2, 3, 1, 5, 6, 4, 7).reshape(cluster, n_gates, units, hp)
    return w.transpose(0, 1).reshape(n_gates * hp, hp)


def wide_weight_rows(wf, plan):
    """The kernel weight W_hh^T [4hp, hp] from a wide forward's operand
    (ops/lstm.py _wide_weight undone by its index map: row m = 64 wg + 16 w
    + 8 hi + r of k-pair p's k8 group kg is gate 2 hi + (r & 1) of the CTA's
    unit 16 wg + 4 w + r // 2, columns 32 p + 8 kg .. + 7), after checking
    its shape against the plan it was packed for; for a GRU's plan (three
    gates) [3hp, hp], after checking that the fourth gate's rows are
    zero."""
    hp, cluster = plan.hidden, plan.cluster
    units = hp // cluster
    assert tuple(wf.shape) == (cluster, hp // 32, 4, 4 * units, 8)
    c, p, kg, m, j = torch.meshgrid(*(torch.arange(n) for n in wf.shape),
                                    indexing="ij")
    wg, w, hi, r = m // 64, m // 16 % 4, m // 8 % 2, m % 8
    gate, unit = 2 * hi + r % 2, 16 * wg + 4 * w + r // 2
    wt = torch.full((4 * hp, hp), float("nan"), dtype=wf.dtype)
    wt[gate * hp + c * units + unit, 32 * p + 8 * kg + j] = wf
    if plan.gates == 3:
        assert not wt[3 * hp:].any()
        return wt[:3 * hp]
    return wt


def stream_dh_weight_rows(wdh, plan, n_gates):
    """The kernel weight W_hh [hp, n*hp] from a streamed backward's second
    operand (ops/lstm.py _stream_dh_weight undone), after checking its shape
    against the plan it was packed for."""
    hp, cluster = plan.hidden, plan.cluster
    units = hp // cluster
    assert tuple(wdh.shape) == (cluster, n_gates * hp // 32, units // 8, 8, 4,
                                2, 2, 2)
    return wdh.permute(0, 2, 3, 1, 5, 6, 4, 7).reshape(hp, n_gates * hp)


def wide_bwd_weight_rows(wrec, wdh, plan):
    """W_hh [hp, 3hp] from the GRU wide backward's two operands (ops/gru.py
    _wide_bwd_weights undone: the recompute's W_hh^T chunks [C][hp/64][8
    k8 groups][3U][8], row q U + u of chunk b and group g holding W_hh[64 b
    + 8 g + j, q hp + c U + u]; the second product's W_hh rows [C][3hp/64][8]
    [U][8], row u of chunk c and group g holding W_hh[c U + u, 64 c + 8 g +
    j]), after checking their shapes against the plan they were packed for
    and that both hold the same weight."""
    hp, cluster = plan.hidden, plan.cluster
    units = hp // cluster
    assert tuple(wrec.shape) == (cluster, hp // 64, 8, 3 * units, 8)
    assert tuple(wdh.shape) == (cluster, 3 * hp // 64, 8, units, 8)
    w = wrec.reshape(cluster, hp // 64, 8, 3, units, 8).permute(
        1, 2, 5, 3, 0, 4).reshape(hp, 3 * hp)
    assert torch.equal(wdh.permute(0, 3, 1, 2, 4).reshape(hp, 3 * hp), w)
    return w


BWD_STREAM_ENTRIES = ("lstm_scan_bwd_stream", "gru_scan_bwd_stream",
                      "lstm_scan_bwd_wide")


def unstream(fn_name, args, plan, n_gates):
    """(entry, arguments, units) of a streamed or wide entry's launch as the
    cluster entry's: W_hh^T unpacked, after checking
    the plan against the H the wrapper passed (its arguments end in ..., B,
    H, reverse), and H padded to stream_hidden's units (the wide forwards'
    to wide_hidden's). A streamed or wide
    backward's two operands (the recompute's W_hh^T and the second
    product's W_hh, each packed on its own) become the cluster backward's
    three: wt, w and wt in fragment order; so does the GRU wide backward's
    (its two operands packed as wgmma's B, H padded to bwd_wide_hidden's
    units)."""
    if fn_name == "gru_scan_bwd_wide":
        from generative_audio_torch.ops import gru as tg
        assert isinstance(plan, tg.GruBwdWidePlan) and plan.hidden == args[-2]
        w = wide_bwd_weight_rows(args[3], args[4], plan)
        wt = w.t().contiguous()
        return ("gru_scan_bwd", (*args[:3], wt, w, tl._fragment_weight(wt),
                                 *args[5:]), tg.bwd_wide_hidden(1, plan.cluster))
    if fn_name in BWD_STREAM_ENTRIES:
        kind = (tl.BwdWidePlan if fn_name.endswith("_wide")
                else tl.BwdStreamPlan)
        assert isinstance(plan, kind) and plan.hidden == args[-2]
        k = 4 if n_gates == 4 else 3          # where the packed operands lie
        wt = stream_weight_rows(args[k], plan, n_gates)
        w = stream_dh_weight_rows(args[k + 1], plan, n_gates)
        return (fn_name.rsplit("_", 1)[0],
                (*args[:k], wt, w, tl._fragment_weight(wt), *args[k + 2:]),
                tl.stream_hidden(1, plan.cluster))
    if fn_name.endswith("_wide"):
        assert isinstance(plan, tl.WidePlan) and plan.hidden == args[-2]
        return (fn_name.rsplit("_", 1)[0],
                (args[0], wide_weight_rows(args[1], plan), *args[2:]),
                tl.wide_hidden(1, plan.cluster))
    assert isinstance(plan, tl.StreamPlan) and plan.hidden == args[-2]
    wt = stream_weight_rows(args[1], plan, n_gates)
    return (fn_name.rsplit("_", 1)[0], (args[0], wt, *args[2:]),
            tl.stream_hidden(1, plan.cluster))
