"""The port's roofline terms (``launch/hlo_analysis.py``) against the
reference's: with the reference's TPU constants passed in as the rates,
``roofline_terms``, ``dominant`` and ``model_flops`` give the reference's
values exactly on the cases of ``tests/test_hlo_analysis.py``; with no
rates given they divide by the H100 SXM datasheet's. ``collective_bytes``
over the records of the reference's HLO snippet gives its operand and
wire bytes."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro.launch import hlo_analysis as ref  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402

REF_RATES = {"peak_flops": ref.PEAK_FLOPS, "hbm_bw": ref.HBM_BW,
             "link_bw": ref.ICI_BW}
CASES = [(197e12, 819e9, 50e9, 256), (1e12, 819e9, 100e9, 256),
         (3.5e15, 2e9, 0.0, 1), (0.0, 0.0, 0.0, 1), (1e9, 1e12, 1e9, 512)]


@pytest.mark.parametrize("case", CASES)
def test_roofline_terms_and_dominant_match_reference(case):
    got = H.roofline_terms(*case, **REF_RATES)
    want = ref.roofline_terms(*case)
    assert got == want
    assert H.dominant(got) == ref.dominant(want)


def test_reference_cases():
    t = H.roofline_terms(197e12, 819e9, 50e9, 256, **REF_RATES)
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 1.0) < 1e-9
    assert abs(t["collective_s"] - 1.0) < 1e-9
    t2 = H.roofline_terms(1e12, 819e9, 100e9, 256, **REF_RATES)
    assert H.dominant(t2) == "collective_s"


def test_h100_rates_by_default():
    t = H.roofline_terms(989e12, 3.35e12, 450e9, 1)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    assert H.dominant({"compute_s": 1.0, "memory_s": 2.0,
                       "collective_s": 0.0}) == "memory_s"


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("n,tokens", [(1.18e9, 2048.0), (3.7e8, 128.0)])
def test_model_flops_matches_reference(kind, n, tokens):
    assert H.model_flops(n, tokens, kind) == ref.model_flops(n, tokens, kind)


def test_collective_bytes_match_reference_hlo_snippet():
    """The collectives of the reference's HLO snippet
    (``tests/test_hlo_analysis.py``) as an eager step issues them: the
    all-gather of f32[128] over 16 devices once, the all-reduce of f32[8]
    over 16 devices in each of the loop's 16 trips. The port counts
    every trip, so its operand bytes are the reference's trip-corrected
    ones, and so are its wire bytes."""
    from test_hlo_analysis import HLO
    records = [("all-gather", 128 * 4, 16)] + [("all-reduce", 8 * 4, 16)] * 16
    raw, corrected, wire = H.collective_bytes(records)
    _, ref_corrected, ref_wire = ref.collective_bytes(HLO)
    assert raw == corrected == ref_corrected
    assert wire == ref_wire
    assert H.collective_bytes([("reduce-scatter", 64, 4),
                               ("all-to-all", 64, 4),
                               ("collective-permute", 64, 2)]) == (
        {"reduce-scatter": 256, "all-to-all": 64, "collective-permute": 64},
        {"reduce-scatter": 256, "all-to-all": 64, "collective-permute": 64},
        {"reduce-scatter": 192, "all-to-all": 48, "collective-permute": 64})
