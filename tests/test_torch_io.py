"""tpulsar_torch's host copies (io/, plan/, search/sifting) against the
JAX package's originals: the same files, bytes and plans."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpulsar.io import accelcands as jac  # noqa: E402
from tpulsar.io import datafile as jdf  # noqa: E402
from tpulsar.io import psrfits as jpf  # noqa: E402
from tpulsar.io import synth as jsy  # noqa: E402
from tpulsar.plan import ddplan as jdp  # noqa: E402
from tpulsar.search import sifting as jsift  # noqa: E402
from tpulsar_torch.io import accelcands as tac  # noqa: E402
from tpulsar_torch.io import datafile as tdf  # noqa: E402
from tpulsar_torch.io import psrfits as tpf  # noqa: E402
from tpulsar_torch.io import synth as tsy  # noqa: E402
from tpulsar_torch.plan import ddplan as tdp  # noqa: E402
from tpulsar_torch.search import sifting as tsift  # noqa: E402


@pytest.fixture(scope="module")
def beam(tmp_path_factory):
    d = tmp_path_factory.mktemp("beam")
    spec = jsy.BeamSpec(nchan=32, nsamp=4096, nbits=4, seed=5)
    jp = jsy.synth_beam(str(d / "j"), spec,
                        pulsars=[jsy.PulsarSpec(0.1, 30.0)])
    tp = tsy.synth_beam(str(d / "t"),
                        tsy.BeamSpec(**dataclasses.asdict(spec)),
                        pulsars=[tsy.PulsarSpec(0.1, 30.0)])
    return jp, tp


def test_synth_writes_identical_files(beam):
    jp, tp = beam
    with open(jp[0], "rb") as a, open(tp[0], "rb") as b:
        assert a.read() == b.read()


def test_psrfits_reads_identical_blocks(beam):
    """The port keeps only the NumPy unpack path; it decodes the same
    float32 and uint8 blocks as the JAX package (whose native path is
    bit-identical to its NumPy path)."""
    jp, tp = beam
    js, ts = jpf.SpectraInfo(jp), tpf.SpectraInfo(tp)
    np.testing.assert_array_equal(ts.read_all(), js.read_all())
    for a, b in zip(ts.read_all_uint8(), js.read_all_uint8()):
        np.testing.assert_array_equal(a, b)
    assert (ts.N, ts.dt, ts.num_channels) == (js.N, js.dt, js.num_channels)


def test_datafile_object_matches(beam, tmp_path):
    jp, tp = beam
    jo, to = jdf.autogen_dataobj(jp), tdf.autogen_dataobj(tp)
    assert type(to).__name__ == type(jo).__name__
    for f in ("beam_id", "source_name", "timestamp_mjd", "project_id",
              "galactic_longitude", "galactic_latitude"):
        assert getattr(to, f) == getattr(jo, f)
    assert tdf.preprocess(tp) == tp and jdf.preprocess(jp) == jp
    # the WAPP position fix takes its coordinate table as an argument
    # (this package keeps no settings layer); a missing table is a no-op
    wapp = object.__new__(tdf.WappPsrfitsData)
    wapp.fns = list(tp)
    assert wapp.preprocess(coords_table=str(tmp_path / "none")) == tp


def test_slab_writer_reads_back(tmp_path):
    """A beam written in slabs decodes to unit-variance quantized noise
    with every channel's median on one level, and the slab count does
    not change the file."""
    spec = tsy.BeamSpec(nchan=16, nsamp=2048, nbits=4, nsblk=64, seed=3)
    a = tsy.synth_beam_slabs(str(tmp_path / "a"), spec, slab_nsamp=512,
                             device="cpu")
    b = tsy.synth_beam_slabs(str(tmp_path / "b"), spec, slab_nsamp=2048,
                             device="cpu")
    with open(a[0], "rb") as fa, open(b[0], "rb") as fb:
        assert fa.read() == fb.read()
    blk = tpf.SpectraInfo(a).read_all()
    assert blk.shape == (2048, 16)
    assert abs(float(blk.mean())) < 0.1
    assert 0.9 < float(blk.std()) < 1.1
    assert len(set(np.median(blk, axis=0).round(5))) == 1
    js = jpf.SpectraInfo(a)          # the JAX reader takes it too
    np.testing.assert_array_equal(js.read_all(), blk)


def test_plans_and_choose_n_match():
    assert tdp.survey_plan("pdev") == [
        tdp.DedispStep(*dataclasses.astuple(s))
        for s in jdp.survey_plan("pdev")]
    for n in (1000, 3932160, 393216, 786432, 1310720):
        assert tdp.choose_n(n) == jdp.choose_n(n)
    assert tdp.total_dm_trials(tdp.survey_plan("pdev")) == 4188


def test_sifting_and_candlist_identical(tmp_path):
    rng = np.random.default_rng(8)
    raw = []
    for k in range(60):
        f = float(rng.choice([4.0, 8.0, 12.0, 7.3])) * (1 + 1e-6 * k)
        raw.append(dict(r=f * 100, z=0.0,
                        sigma=float(rng.uniform(3, 30)),
                        power=float(rng.uniform(10, 100)),
                        numharm=int(rng.choice([1, 2, 4, 8])),
                        dm=float(rng.choice([10.0, 10.5, 11.0, 40.0])),
                        period_s=1.0 / f, freq_hz=f))
    js = jsift.sift([jsift.Candidate(**c) for c in raw])
    ts = tsift.sift([tsift.Candidate(**c) for c in raw])
    assert [dataclasses.asdict(c) for c in ts] == \
        [dataclasses.asdict(c) for c in js]
    jac.write_candlist(js, str(tmp_path / "j"), baryv=1e-4)
    tac.write_candlist(ts, str(tmp_path / "t"), baryv=1e-4)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    assert len(tac.parse_candlist(str(tmp_path / "j"))) == len(js)
