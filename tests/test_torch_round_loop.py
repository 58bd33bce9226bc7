"""The port's scanned round driver (``jit_rounds=True``) on the CPU.

On the CPU the driver runs the same round step as on the card, eagerly
(one CUDA graph a round is the card's), in segments of ``eval_every``
rounds, every ``functional.cond`` running both branches and picking on
the device.  Held here, on the reference's round-loop spec
(``tests/test_round_loop.py``: paper-mlp, 12 clients, K = 3):

(a) against the port's host loop: identical participants, train loss
    and the last round's Ĥ within 1e-5 (the reference's own
    host-vs-scan tolerance; measured: bit-equal);
(b) against the reference's ``jit_rounds=True`` through the replayed
    key chain (``torch_parity.JaxKeyChain``) from the reference's
    initial params: identical participants, DivFL's ideal mode to the
    horizon ``tests/test_torch_baselines.py`` measured for it;
(c) the round step built once across four segments;
(d) the round step reading nothing on the host;
(e) the state written back: a host-loop round follows a scanned run;
(f) ``LocalSpec(optimizer="adam")``: the scanned driver bit-equal to
    the host loop.

Each test loops over its cases (``torch_parity.each``).
"""
import numpy as np
import pytest
import torch

from repro.data import SyntheticSpec as JaxSyntheticSpec
from repro.fed import ExperimentSpec as JaxExperimentSpec
from repro.fed import LocalSpec as JaxLocalSpec
from repro.fed import build as jax_build
from repro_torch.core.selectors.functional import both_branches
from repro_torch.data import SyntheticSpec
from repro_torch.fed import ExperimentSpec, LocalSpec, build
from repro_torch.models import params_from_jax
from repro_torch.optim import tree_leaves
from torch_parity import JaxKeyChain, each, to_np

#: (selector, selector_kw) of every run the port's drivers take
HICS = [("hics", None), ("hics", {"incremental": False})]
BASELINES = [("random", None), ("pow-d", None), ("cs", None),
             ("divfl", {"refresh": "selected"}), ("fedcor", None)]
#: DivFL's ideal mode against the reference, from
#: tests/test_torch_baselines.py
DIVFL_IDEAL_HORIZON = 12
#: the host reads a round step must not make
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__",
              "__index__")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs' tensors are tiny: more torch threads than one only
    spin against the other test workers' (measured: a 12-round run 0.3 s
    on one thread, 54 s on eight beside three more such processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(selector, jit_rounds, rounds=20, selector_kw=None,
          optimizer="sgd"):
    return ExperimentSpec(
        arch="paper-mlp", num_clients=12, num_select=3, rounds=rounds,
        alphas=(0.05, 5.0), selector=selector, selector_kw=selector_kw,
        local=LocalSpec(optimizer=optimizer, lr=0.1, epochs=2,
                        batch_size=32),
        samples_train=600, samples_test=200, eval_every=5, seed=0,
        jit_rounds=jit_rounds)


def _host_vs_scan(rounds, selector, kw):
    host = build(_spec(selector, False, rounds, kw), device="cpu")[0].run()
    scan = build(_spec(selector, True, rounds, kw), device="cpu")[0].run()
    assert scan["selected"] == host["selected"]
    assert len(scan["selected"]) == rounds
    np.testing.assert_allclose(scan["train_loss"], host["train_loss"],
                               atol=1e-5)
    if host["bias_entropy"][-1] is None:
        assert scan["bias_entropy"] == [None] * rounds
    else:
        np.testing.assert_allclose(scan["bias_entropy"][-1],
                                   host["bias_entropy"][-1], atol=1e-5)
    segments = [5] * (rounds // 5) + ([rounds % 5] if rounds % 5 else [])
    assert scan["segment_rounds"] == segments
    assert scan["wall_s"] == [] and scan["rounds_per_s"] > 0
    # evaluation after each segment's last round
    assert scan["test_round"] == list(np.cumsum(segments) - 1)


def test_scan_matches_host_loop_hics_20_rounds():
    """(a) HiCS, incremental and from scratch, over 20 rounds: four
    coverage rounds, then ward, in both drivers."""
    each(_host_vs_scan, [20], *zip(*HICS))


def test_scan_matches_host_loop_adam_bit_equal():
    """``LocalSpec(optimizer="adam")`` through both drivers, 10 rounds
    of HiCS: the scanned round step makes adam's state (moments and a
    0-d int32 count) inside the round, and every participant, train
    loss, Ĥ and final param equals the host loop's bit for bit."""
    servers = [build(_spec("hics", jit, 10, optimizer="adam"),
                     device="cpu")[0] for jit in (False, True)]
    host, scan = (s.run() for s in servers)
    assert scan["selected"] == host["selected"]
    assert len(scan["selected"]) == 10
    assert scan["train_loss"] == host["train_loss"]
    assert scan["bias_entropy"] == host["bias_entropy"]
    for a, b in zip(*(tree_leaves(s.params) for s in servers)):
        assert torch.equal(a, b)


def test_scan_matches_host_loop_baselines_12_rounds():
    """(a) the baselines, DivFL's ideal mode too, over 12 rounds."""
    each(_host_vs_scan, [12],
         *zip(*(BASELINES + [("divfl", None)])))


def _vs_reference(rounds, horizon, selector, kw):
    common = dict(arch="paper-mlp", num_clients=12, num_select=3,
                  rounds=rounds, alphas=(0.05, 5.0), selector=selector,
                  selector_kw=kw, samples_train=600, samples_test=200,
                  eval_every=5, seed=0, jit_rounds=True)
    jserver, _ = jax_build(JaxExperimentSpec(
        data=JaxSyntheticSpec(), local=JaxLocalSpec(
            algo="fedavg", optimizer="sgd", lr=0.1, epochs=2,
            batch_size=32), **common))
    tserver, _ = build(ExperimentSpec(
        data=SyntheticSpec(), local=LocalSpec(lr=0.1, epochs=2,
                                              batch_size=32), **common),
        device="cpu")
    tserver.params = params_from_jax(to_np(jserver.params), "cpu")
    chain = JaxKeyChain(0, 12, 3, 3, 2, tserver.x.shape[1],
                        grad_all="full_all" in tserver.requires)
    jhist, thist = jserver.run(), tserver.run(draws=chain)
    assert len(thist["selected"]) == rounds
    assert thist["selected"][:horizon] == jhist["selected"][:horizon]
    np.testing.assert_allclose(thist["train_loss"][:horizon],
                               jhist["train_loss"][:horizon], rtol=1e-4)


def test_scan_matches_reference_scan_hics():
    """(b) HiCS, incremental and from scratch, 20 rounds."""
    each(_vs_reference, [20], [20], *zip(*HICS))


def test_scan_matches_reference_scan_samplers():
    """(b) random, pow-d and cs, 12 rounds."""
    each(_vs_reference, [12], [12], *zip(*BASELINES[:3]))


def test_scan_matches_reference_scan_divfl_selected_fedcor():
    """(b) divfl-selected and fedcor, 12 rounds (FedCor's GP from
    round 10)."""
    each(_vs_reference, [12], [12], *zip(*BASELINES[3:]))


def test_scan_matches_reference_scan_divfl_ideal():
    """(b) DivFL's ideal mode, to its measured horizon."""
    _vs_reference(14, DIVFL_IDEAL_HORIZON, "divfl", None)


def test_round_step_built_once():
    """(c) 20 rounds at eval_every 5 are four segments of one round
    step."""
    server, _ = build(_spec("hics", True), device="cpu")
    built, make = [], server._make_round_step

    def counting():
        built.append(1)
        return make()

    server._make_round_step = counting
    hist = server.run()
    assert hist["segment_rounds"] == [5, 5, 5, 5]
    assert len(hist["round"]) == 20
    assert len(built) == 1, f"round step built {len(built)} times"
    server.run()
    assert len(built) == 1


def _no_host_reads(selector, kw):
    server, _ = build(_spec(selector, True, rounds=4, selector_kw=kw),
                      device="cpu")
    step = server._make_round_step()
    carry = (server.params, server.extras, server.state,
             torch.zeros((), dtype=torch.int32))
    draws = [server._draw_host(t) for t in range(4)]
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def host_read(*args, **kwargs):
        raise AssertionError("a host read inside the round step")

    try:
        for name in saved:
            setattr(torch.Tensor, name, host_read)
        if selector != "random":     # the host loop reads its branch
            with pytest.raises(AssertionError, match="host read"):
                server.selector.select(server.state, 0, draws[0].select)
        for rd in draws:
            carry, out = step(carry, rd)
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
    assert int(carry[3]) == 4 and len(set(out[0].tolist())) == 3


def test_round_step_reads_nothing_on_the_host():
    """(d) 4 rounds of every selector's round step with the host reads
    patched to raise: both branches of every ``cond`` run in every
    round, from the zero state of round 0 on."""
    each(_no_host_reads, *zip(*(HICS + BASELINES + [("divfl", None)])))


def test_scan_state_writeback():
    """(e) after a scanned run the server holds the final round's
    params and state, and a host-loop round continues from them."""
    server, _ = build(_spec("hics", True, rounds=10), device="cpu")
    hist = server.run()
    assert int(server.state.hist_count) == 10
    assert bool(server.state.seen.all())             # the sweep is done
    host, _ = build(_spec("hics", False, rounds=10), device="cpu")
    host.run()
    for a, b in zip(server.state, host.state):
        assert torch.equal(a, b)
    assert torch.equal(server.params["lm_head"]["b"],
                       host.params["lm_head"]["b"])
    ids, metrics = server.step(10, server.draw_round(10))
    assert len(set(ids.tolist())) == 3
    assert bool(torch.isfinite(metrics["train_loss"]).all())
    assert int(server.state.hist_count) == 11
    assert len(hist["selected"]) == 10
    with both_branches():      # the scanned select from the same state
        ids2, _ = server.selector.select(host.state, 10,
                                         host.draw_round(10).select)
    assert len(set(ids2.tolist())) == 3
