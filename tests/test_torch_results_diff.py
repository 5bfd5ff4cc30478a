"""tools/torch_results_diff.py's rule for a .bestprof at --rtol (two
packages' results): the profile block is held like a float .npz array,
at rtol * max|profile| plus one unit of the last printed digit, and
every "#" header field token by token, as every other text file.  The
file is the port's own (FoldResult.bestprof_text) inside a
``_bestprof.tgz``, the way the served, gateway and pipeline tests meet
it; rtol 1e-5 as they use it."""

import io
import tarfile

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_checkpoint import results_diff  # noqa: E402
from tpulsar_torch.kernels.fold import FoldResult  # noqa: E402

RTOL = 1e-5
MEMBER = "beam_cand1.bestprof"


def _profile() -> np.ndarray:
    """A mean-subtracted float32 pulse profile of 100 bins (max|b|
    ~83): most bins sit near -6.8, one crosses zero on each flank."""
    x = np.arange(100)
    prof = 90.0 * np.exp(-0.5 * ((x - 50) / 3.0) ** 2)
    return (prof - prof.mean()).astype(np.float32)


def _tgz(profile: np.ndarray, chi2: float = 1157.6543) -> bytes:
    fold = FoldResult(period_s=0.249996015, pdot=0.0, dm=50.0, nbin=100,
                      npart=30, profile=profile,
                      subints=np.zeros((30, 100), np.float32),
                      reduced_chi2=chi2, delta_p=0.0, delta_pdot=0.0)
    data = fold.bestprof_text("beam").encode()
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        info = tarfile.TarInfo(MEMBER)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


@pytest.mark.parametrize("case, same", [
    ("uniform offset of 0.5 rtol max|b|", True),
    ("one bin displaced by 3 rtol max|b|", False),
    ("Reduced chi-sqr changed by 2 rtol", False),
    ("one bin fewer", False),
])
def test_bestprof_profile_held_at_its_scale(case, same):
    rd = results_diff()
    want = _profile()
    scale = float(np.abs(want).max())
    got, chi2 = want.copy(), 1157.6543
    if case.startswith("uniform"):
        got += np.float32(0.5 * RTOL * scale)
        # the per-token rule holds the bins near zero far tighter
        text = [tarfile.open(fileobj=io.BytesIO(b)).extractfile(
            MEMBER).read() for b in (_tgz(got), _tgz(want))]
        assert not rd._text_equal(*text, RTOL)
    elif case.startswith("one bin displaced"):
        got[87] += np.float32(3 * RTOL * scale)
    elif case.startswith("Reduced"):
        chi2 *= 1 + 2 * RTOL
    else:
        got = got[:-1]
    diff = rd._content_diff("beam_bestprof.tgz", _tgz(got, chi2),
                            _tgz(want), "beam_bestprof.tgz", RTOL)
    assert diff == ([] if same else
                    [f"beam_bestprof.tgz:{MEMBER}: bytes differ"])
