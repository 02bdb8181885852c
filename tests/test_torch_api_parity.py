"""The port's public API held to the JAX package's, call for call.

Part one reads source only: every module of ``sdr_channelizer_tpu`` has its
counterpart in ``sdr_channelizer_tpu_torch`` at the same path
(``ops/pallas`` -> ``ops/cuda``), with every public function, class and
method, and every parameter of each under the same name and default.  The
differences allowed are the entries of ``ALLOWED``, each with its reason.
Both command lines have the same subcommands, options and defaults, the
port's ``--device`` added; each ``pl.pallas_call`` site of the JAX package
is a key of ``KERNEL_SITES`` in ``tests/test_torch_card_kernels.py``, whose
value names the card case there that holds its CUDA kernel, and is named by
a row of ``PERF.md`` section 6.

Part two makes the calls: ``tests/test_channelizer.py``'s call forms
(``chan(x)``, ``shift``, truncation, the tone in its channel) and batched
captures on the port, on the CPU, against the JAX call on the same NumPy
inputs at the JAX test's tolerances; ``method="auto"``; ``hysteresis_scan``
along either dimension; the streamed block's history through the
channelizer kernel's wrapper.

Run alone: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_api_parity.py -q -p no:cacheprovider``.
"""

import argparse
import ast
import importlib
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.dsp import channelizer as jchan
from sdr_channelizer_tpu.dsp import pdw as jpdw
from sdr_channelizer_tpu_torch.dsp import channelizer as tchan
from sdr_channelizer_tpu_torch.dsp import pdw as tpdw
from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "sdr_channelizer_tpu"
PORT_PKG = REPO / "sdr_channelizer_tpu_torch"

# Every way the port's public signatures may differ from the JAX package's.
# ("renamed", old, new): a parameter of that name, wherever it appears;
# ("jax only", module, function, parameter or None for the function itself);
# ("port only", parameter): a parameter the port adds, wherever it appears.
ALLOWED = {
    ("renamed", "axis", "dim"):
        "PyTorch idiom: torch reductions name the dimension `dim`",
    ("jax only", "ops/medians.py", "median", "method"):
        "TPU-only knob: picks the sort-free radix select where XLA's sort "
        "does not lower on the TPU backend; the port sorts on every device",
    ("jax only", "ops/medians.py", "median", "bits"):
        "TPU-only knob: radix bits a counting pass of that select",
    ("jax only", "ops/medians.py", "masked_median", "method"):
        "TPU-only knob: as median's method",
    ("jax only", "ops/medians.py", "masked_median", "bits"):
        "TPU-only knob: as median's bits",
    ("jax only", "ops/medians.py", "use_sort_free", None):
        "TPU-backend switch behind the medians' method=None; the port has "
        "no sort-free form to switch to",
    ("jax only", "ops/rank_find.py", "find_ranks_cm", "block"):
        "TPU-only knob: the block of the two-level search that avoids the "
        "TPU's slow gathers; the port is one torch.searchsorted",
    ("jax only", "ops/rank_find.py", "take_at_cm", "block"):
        "TPU-only knob: the contiguous block read a query on the TPU; the "
        "port is one indexed read",
    ("jax only", "dsp/pdw.py", "noise_floor_cm", "bits"):
        "TPU-only knob: radix bits a pass of the per-pass XLA descent; on "
        "the card the floor is kernel K2's select",
    ("port only", "device"):
        "the port's device selector: the card unless the caller asks for "
        "the CPU",
    ("port only", "ops"):
        "the port's kernel selector: the CUDA kernels or their plain "
        "versions",
    ("port only", "plain"):
        "the port's switch to the kernels' plain versions",
}
RENAMES = {k[1]: k[2] for k in ALLOWED if k[0] == "renamed"}


# ------------------------------------------------------------ part one

def _rel(path: pathlib.Path, root: pathlib.Path) -> str:
    return path.relative_to(root).as_posix()


def _port_path(rel: str) -> str:
    return re.sub(r"^ops/pallas/", "ops/cuda/", rel)


def _public(path: pathlib.Path) -> dict:
    """``{name: node}`` of a module's public top-level functions and
    classes, and of its classes' public methods (``Class.method``, with
    ``__call__`` and ``__init__``)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out[node.name] = node
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        not sub.name.startswith("_")
                        or sub.name in ("__call__", "__init__")):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _params(fn: ast.FunctionDef) -> list:
    """``[(name, default source or None, keyword-only)]`` but self / cls."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + a.defaults
    out = [(p.arg, d, False) for p, d in zip(pos, defaults)]
    out += [(p.arg, d, True) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    return [(n, None if d is None else ast.unparse(d), kw)
            for n, d, kw in out if n not in ("self", "cls")]


JAX_MODULES = sorted(_rel(p, JAX_PKG) for p in JAX_PKG.rglob("*.py"))
AUDITED = [m for m in JAX_MODULES if not m.startswith("ops/pallas/")]


def _signature_diffs() -> dict:
    """Every difference of the port's public names and signatures from the
    JAX package's: ``{allow-list key: [where, ...]}``, with the key None
    for a difference the allow-list does not hold."""
    diffs = {}

    def note(key, where):
        diffs.setdefault(key if key in ALLOWED else None, []).append(where)

    for rel in AUDITED:
        ours = _public(PORT_PKG / rel)
        for name, node in _public(JAX_PKG / rel).items():
            fn = name.split(".")[-1]
            if name not in ours:
                note(("jax only", rel, fn, None), f"{rel}: {name} missing")
                continue
            if isinstance(node, ast.ClassDef):
                continue
            port = {n: d for n, d, _ in _params(ours[name])}
            order = []
            for p, default, _ in _params(node):
                q = RENAMES.get(p, p)
                if q != p:
                    note(("renamed", p, q), f"{rel}: {name}({p})")
                if q not in port:
                    note(("jax only", rel, fn, p),
                         f"{rel}: {name} lacks {p}={default}")
                    continue
                order.append(q)
                if port[q] != default:
                    note(("default", rel, fn, p),
                         f"{rel}: {name}({q}) defaults to {port[q]}, "
                         f"the JAX package's to {default}")
            ported = [q for q, _, _ in _params(ours[name]) if q in order]
            if ported != order:
                note(("order", rel, name),
                     f"{rel}: {name} orders {ported}, the JAX package "
                     f"{order}")
            expected = {RENAMES.get(p, p) for p, _, _ in _params(node)}
            for q in port:
                if q not in expected:
                    note(("port only", q), f"{rel}: {name} adds {q}")
    return diffs


@pytest.fixture(scope="module")
def signature_diffs():
    return _signature_diffs()


def test_every_module_has_its_counterpart():
    missing = [m for m in JAX_MODULES
               if not (PORT_PKG / _port_path(m)).is_file()]
    assert not missing, f"modules with no counterpart in the port: {missing}"


@pytest.mark.parametrize("rel", AUDITED)
def test_public_names_and_signatures_match(rel, signature_diffs):
    """Every public name of the JAX module is in the port's module, and
    every parameter under the same name with the same default, in the same
    order, but for what ``ALLOWED`` holds."""
    faults = [w for w in signature_diffs.get(None, [])
              if w.startswith(f"{rel}:")]
    assert not faults, "\n".join(faults)


def test_every_allowed_difference_is_still_there(signature_diffs):
    """The allow-list holds nothing the packages no longer differ by."""
    stale = [k for k in ALLOWED if k not in signature_diffs]
    assert not stale, f"entries that no difference uses: {stale}"


def test_channelizer_call_forms_are_all_there():
    """The repairs the audit asks for, by name: ``Channelizer.__call__``,
    ``method="auto"`` as every default, ``hysteresis_scan``'s dim."""
    names = _public(PORT_PKG / "dsp/channelizer.py")
    assert "Channelizer.__call__" in names
    for name in ("Channelizer.__call__", "Channelizer.stream_block",
                 "channelize", "resolve_method"):
        assert dict((p, d) for p, d, _ in _params(names[name]))["method"] \
            == "'auto'", name
    scan = _public(PORT_PKG / "dsp/pdw.py")["hysteresis_scan"]
    assert ("dim", "-1", False) in _params(scan)


class _Parser(Exception):
    pass


def _parser_of(module_name: str, monkeypatch) -> argparse.ArgumentParser:
    """The parser a CLI's ``main()`` builds, caught as it parses."""
    main = importlib.import_module(module_name).main

    def grab(self, *args, **kwargs):
        raise _Parser(self)

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parser) as got:
            main(["generate"])
    return got.value.args[0]


def _options(parser: argparse.ArgumentParser) -> dict:
    """``{subcommand or "": {option strings (or dest): default}}``."""
    def table(p):
        return {tuple(a.option_strings) or (a.dest,): a.default
                for a in p._actions
                if not isinstance(a, (argparse._HelpAction,
                                      argparse._SubParsersAction))}

    out = {"": table(parser)}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            out.update({name: table(sub)
                        for name, sub in action.choices.items()})
    return out


def test_cli_subcommands_options_and_defaults_match(monkeypatch):
    ref = _options(_parser_of("sdr_channelizer_tpu.cli.main", monkeypatch))
    got = _options(_parser_of("sdr_channelizer_tpu_torch.cli.main",
                              monkeypatch))
    assert sorted(got) == sorted(ref)
    assert len(ref) > 8
    for cmd, options in ref.items():
        extra = {k: v for k, v in got[cmd].items() if k not in options}
        assert extra in ({}, {("--device",): None}), (cmd, extra)
        assert {k: got[cmd][k] for k in options} == options, cmd


def _pallas_call_sites() -> list:
    sites = []
    for path in sorted((JAX_PKG / "ops/pallas").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) \
                    and ast.unparse(node.func) == "pl.pallas_call":
                sites.append(f"{path.name}:{node.lineno}")
    return sites


def _card_kernel_sites():
    """``KERNEL_SITES`` of the card's kernel tests, read from the source,
    and the names of the test functions beside it."""
    tree = ast.parse((REPO / "tests/test_torch_card_kernels.py").read_text())
    sites = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and [ast.unparse(t) for t in node.targets] == ["KERNEL_SITES"])
    tests = {node.name for node in tree.body
             if isinstance(node, ast.FunctionDef)
             and node.name.startswith("test_")}
    return sites, tests


def test_every_pallas_call_has_its_chip_row_and_its_perf_row():
    """Each site is a key of ``KERNEL_SITES`` naming a card case of
    ``tests/test_torch_card_kernels.py``, and a row of PERF.md section 6
    names it."""
    sites = _pallas_call_sites()
    assert len(sites) == 9, sites
    card_sites, card_tests = _card_kernel_sites()
    perf = (REPO / "PERF.md").read_text()
    findings = perf[perf.index("## 6. Findings"):perf.index("## 7.")]
    rows = [line for line in findings.splitlines() if line.startswith("| ")]
    for site in sites:
        assert card_sites.get(site) in card_tests, \
            f"no card case of KERNEL_SITES holds {site}"
        assert any(f"`{site}`" in row for row in rows), \
            f"no row of PERF.md section 6 names {site}"


# ------------------------------------------------------------ part two

def _noise(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


BRUTE_CASES = [(8, 12), (5, 4), (16, 12), (7, 3)]
TONES = [-7, -3, 0, 2, 5]
BATCHES = [(2,), (3, 1)]


@pytest.fixture(scope="module")
def jax_calls():
    """Each JAX call once: the inputs and what the JAX package answers."""
    out = {}
    rng = np.random.default_rng(42)
    for m, p in BRUTE_CASES:
        x = _noise(rng, m * 50)
        ch = jchan.Channelizer.create(m, taps_per_band=p)
        out["brute", m, p] = x, np.asarray(ch(x, shift=False))
    ch = jchan.Channelizer.create(8)
    x = np.ones(8 * 40, np.complex64)
    out["shift"] = x, np.asarray(ch(x, shift=True)), np.asarray(
        ch(x, shift=False))
    x = np.ones(8 * 10 + 3, np.complex64)
    out["truncate"] = x, np.asarray(ch(x))
    ch = jchan.Channelizer.create(16)
    fs = 16e6
    for k_off in TONES:
        t = np.arange(16 * 200) / fs
        x = np.exp(2j * np.pi * (k_off * fs / 16) * t).astype(np.complex64)
        out["tone", k_off] = x, np.asarray(ch(x, shift=True))
    ch = jchan.Channelizer.create(8)
    for lead in BATCHES:
        x = _noise(rng, *lead, 8 * 64 + 5)
        out["batch", lead] = x, np.asarray(ch(jnp.asarray(x)))
    x = _noise(rng, 8 * 64)
    out["auto"] = x, np.asarray(jchan.channelize(jnp.asarray(x), ch,
                                                 method="auto"))
    return out


def _close(got: torch.Tensor, want: np.ndarray, **tol):
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("m,p", BRUTE_CASES)
def test_call_matches_jax_at_the_brute_force_cases(jax_calls, m, p):
    """``tests/test_channelizer.py::test_matches_brute_force``'s calls."""
    x, want = jax_calls["brute", m, p]
    chan = tchan.Channelizer.create(m, taps_per_band=p)
    _close(chan(x, shift=False, device="cpu"), want, atol=2e-5)


def test_call_shifts_and_shapes_as_jax(jax_calls):
    x, want, want_ns = jax_calls["shift"]
    chan = tchan.Channelizer.create(8)
    y = chan(x, shift=True, device="cpu")
    y_ns = chan(x, shift=False, device="cpu")
    assert y.shape == (40, 8)
    np.testing.assert_allclose(y.numpy(), np.fft.fftshift(y_ns.numpy(),
                                                           axes=-1),
                               rtol=1e-6)
    _close(y, want, atol=2e-5)
    _close(y_ns, want_ns, atol=2e-5)


def test_call_truncates_to_a_multiple_of_m_as_jax(jax_calls):
    x, want = jax_calls["truncate"]
    _close(tchan.Channelizer.create(8)(x, device="cpu"), want, atol=2e-5)


@pytest.mark.parametrize("k_off", TONES)
def test_call_puts_a_tone_in_its_channel_as_jax(jax_calls, k_off):
    x, want = jax_calls["tone", k_off]
    chan = tchan.Channelizer.create(16)
    y = chan(x, shift=True, device="cpu")
    _close(y, want, atol=2e-5)
    steady = y.abs().numpy()[chan.taps_per_band + 2:]
    idx = int(np.argmax(steady.mean(axis=0)))
    assert chan.center_frequencies(16e6)[idx] == pytest.approx(k_off * 1e6)
    assert steady[:, idx].mean() == pytest.approx(1.0, abs=0.02)


@pytest.mark.parametrize("lead", BATCHES)
def test_batched_capture_matches_jax_and_its_rows(jax_calls, lead):
    """A (..., N) capture gives (..., N // M, M), every row the 1-D call on
    that row, bit for bit."""
    x, want = jax_calls["batch", lead]
    chan = tchan.Channelizer.create(8)
    y = chan(x, device="cpu")
    _close(y, want, atol=2e-5, rtol=1e-6)
    rows = x.reshape(-1, x.shape[-1])
    for r, row in enumerate(rows):
        assert torch.equal(y.reshape(-1, *y.shape[-2:])[r],
                           chan(row, device="cpu"))
    y_dft = tchan.channelize(x, chan, method="dft", device="cpu")
    _close(y_dft, want, atol=2e-5, rtol=1e-6)


def test_auto_is_the_default_and_the_fft_on_the_cpu(jax_calls):
    x, want = jax_calls["auto"]
    chan = tchan.Channelizer.create(8)
    auto = tchan.channelize(x, chan, method="auto", device="cpu")
    _close(auto, want, atol=2e-5, rtol=1e-6)
    assert torch.equal(tchan.channelize(x, chan, device="cpu"), auto)
    assert torch.equal(tchan.channelize(x, chan, method="fft",
                                        device="cpu"), auto)
    y, _ = chan.stream_block(x, chan.init_state("cpu"), method="auto")
    assert torch.equal(y, auto)


def test_auto_resolves_by_the_device():
    assert tchan.resolve_method("auto", "cpu") == "fft"
    assert tchan.resolve_method("dft", "cpu") == "dft"
    assert tchan.resolve_method("auto", "cuda") == "dft"
    assert tchan.resolve_method() == "dft"      # device None: the card
    assert tchan.resolve_method("fft") == "fft"


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_hysteresis_scan_along_a_dim_matches_jax(dim):
    rng = np.random.default_rng(7)
    ge = rng.random((40, 6)) < 0.2
    le = rng.random((40, 6)) < 0.3
    want = np.asarray(jpdw.hysteresis_scan(jnp.asarray(ge), jnp.asarray(le),
                                           axis=dim))
    got = tpdw.hysteresis_scan(torch.from_numpy(ge), torch.from_numpy(le),
                               dim=dim)
    np.testing.assert_array_equal(got.numpy(), want)


def test_streamed_history_through_the_kernel_wrapper():
    """The card's form of ``stream_block`` on the CPU: the channelizer
    kernel's wrapper seeded with the state's last P-1 frames (its plain
    version here) gives the single-shot rows, block after block."""
    rng = np.random.default_rng(3)
    m = 8
    chan = tchan.Channelizer.create(m)
    x = torch.from_numpy(_noise(rng, m * 96))
    whole = channelizer_kernel.channelize_complex(x, chan.taps_rev)
    state = chan.init_state("cpu")
    parts = []
    for lo, hi in ((0, 5), (5, 40), (40, 41), (41, 96)):
        blk = x[lo * m:hi * m]
        parts.append(channelizer_kernel.channelize_complex(
            blk, chan.taps_rev, history=state.frames[1:]))
        dft, state = chan.stream_block(blk, state, method="dft")
        np.testing.assert_allclose(parts[-1].numpy(), dft.numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="history"):
        channelizer_kernel.channelize_complex(x, chan.taps_rev,
                                              history=state.frames)
