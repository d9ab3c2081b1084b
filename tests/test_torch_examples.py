"""The four ``examples/*_torch.py`` run in process at their smallest size
on the CPU (``--device cpu``; on the card they default to ``cuda``), each
printing its reference example's sections and checks:

* ``quickstart_torch --small``: every section's check reads True (the
  ±1 GEMM equal to the dense product and to the crossbar engine);
* ``serve_decode_torch``: 2 requests of 4 new tokens each are served;
* ``train_bnn_torch``: the loss falls over 60 steps with a checkpoint
  every 20 (the script exits non-zero when it does not);
* ``energy_reliability_torch``: energy tables for the three profiles, a
  5-rate sweep and TMR at 32 samples each.
"""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _run(name, argv, capsys):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(argv) == 0
    return capsys.readouterr().out


def test_examples_default_to_the_card():
    for path in EXAMPLES.glob("*_torch.py"):
        src = path.read_text()
        assert 'ap.add_argument("--device", default="cuda"' in src, path
        assert "jax" not in src and "from repro." not in src, path


def test_quickstart(capsys):
    out = _run("quickstart_torch", ["--device", "cpu", "--small"], capsys)
    for n in range(1, 6):
        assert f"\n{n}. " in out or out.startswith("=" * 70 + f"\n{n}. ")
    assert "correct=True" in out and "verified: True" in out
    assert ("equal to the dense product True, to the crossbar engine True"
            in out)
    assert "finite=True" in out and "matches numpy reference: True" in out
    assert "False" not in out


def test_serve_decode(capsys):
    out = _run("serve_decode_torch", ["--device", "cpu", "--requests", "2",
                                      "--max-new", "4"], capsys)
    assert re.search(r"served 2 requests / 8 tokens in .* on cpu\)", out)


def test_train_bnn(capsys):
    out = _run("train_bnn_torch", ["--device", "cpu", "--steps", "60",
                                   "--ckpt-every", "20"], capsys)
    m = re.search(r"final loss ([\d.]+) \(from ([\d.]+)\)", out)
    assert m and float(m.group(1)) < float(m.group(2))


def test_energy_reliability(capsys):
    out = _run("energy_reliability_torch", ["--device", "cpu", "--samples",
                                            "32"], capsys)
    assert out.count("profile=") == 3
    assert "32 fault samples/rate" in out
    assert len(re.findall(r"rate \de-0\d: sign-err", out)) == 3
