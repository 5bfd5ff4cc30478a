"""The hi stage's stage kernel (csrc/accel_stage.cu) on the card
against its plain version, exactly.  The CPU tests of the plain
version, against the torch and native consumers, are in
tests/test_torch_accel.py; this file imports no JAX, so that a machine
with the card runs it: python -m pytest --noconftest -m cuda <this
file>."""

import pytest

torch = pytest.importorskip("torch")

from tpulsar_torch.kernels import accel, cuda_dd  # noqa: E402
from tpulsar_torch.kernels import fourier as fr  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("zmax, mh, nbins, dtype, zchunk", [
    (50.0, 8, 30_001, "f32", 4), (50.0, 8, 30_001, "bf16", 4),
    (200.0, 16, 20_011, "f32", 16), (200.0, 16, 20_011, "bf16", 3),
    (50.0, 1, 777, "f32", 4), (50.0, 2, 300, "bf16", 64)])
def test_cuda_stage_kernel_matches_plain_version(cuda_device, zmax, mh,
                                                 nbins, dtype, zchunk,
                                                 monkeypatch):
    """On the card: the block maxima, their columns and z indices and
    column 0's z index equal the plain version's bit for bit, in one
    launch, and so does the top-k the hi stage takes from them."""
    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_DTYPE", dtype)
    monkeypatch.setenv("TPULSAR_ACCEL_Z_CHUNK", str(zchunk))
    bank = accel.build_template_bank(zmax, seg=1 << 12)
    nz, nr = len(bank.zs), 2 * nbins
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(nbins)
    specs = torch.randn((3, nbins), dtype=torch.complex64,
                        device=cuda_device, generator=gen)
    bf = torch.from_numpy(bank.bank_fft).to(cuda_device)
    pieces = accel._corr_piece_list(specs, bf, bank.seg, bank.step,
                                    bank.width, nz)
    stages = tuple(fr.harmonic_stages(mh))
    before = cuda_dd.LAUNCHES["accel_stage"]
    got = cuda_dd.accel_stage_blocks(pieces, bank.width, nr, stages,
                                     fr.BLOCK_R)
    torch.cuda.synchronize()
    assert cuda_dd.LAUNCHES["accel_stage"] == before + 1
    want = accel._stage_blocks_plain(pieces, bank.width, nr, stages,
                                     fr.BLOCK_R)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    plane = accel._assemble_plane(pieces, bank.width, nr)
    topk = accel._stage_topk(accel._harmonic_stage_maxes(plane, stages, nz),
                             stages, 16)
    for g, w in zip(accel._blocks_topk(got, stages, nr, 16), topk,
                    strict=True):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_stage_kernel_at_its_z_limit(cuda_device, dtype):
    """ACCEL_STAGE_MAX_NZ z rows, whose shared table passes the 48 KB a
    block has without opting in: the launch runs and equals the plain
    version bit for bit."""
    nz, zc, width, nr, stages = cuda_dd.ACCEL_STAGE_MAX_NZ, 1000, 40, 600, \
        (1, 2, 4)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(nz)
    pieces = [torch.rand((2, 3, min(zc, nz - z0), 200), generator=gen,
                         device=cuda_device).to(dtype)
              for z0 in range(0, nz, zc)]
    got = cuda_dd.accel_stage_blocks(pieces, width, nr, stages, fr.BLOCK_R)
    torch.cuda.synchronize()
    want = accel._stage_blocks_plain(pieces, width, nr, stages, fr.BLOCK_R)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_row_program_is_a_one_row_batch(cuda_device):
    """On the card the per-DM row program is a one-row batch through the
    stage kernel: one launch, the same bits as the batched program on
    that row alone, and less peak memory than a batch of two rows; and
    a search counts every batched row as a kernel row."""
    from tpulsar_torch.obs import telemetry

    bank = accel.build_template_bank(50.0, seg=1 << 12)
    nz, nbins = len(bank.zs), 200_003
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(11)
    specs = torch.randn((4, nbins), dtype=torch.complex64,
                        device=cuda_device, generator=gen)
    bf = torch.from_numpy(bank.bank_fft).to(cuda_device)
    kw = dict(seg=bank.seg, step=bank.step, width=bank.width, nz=nz,
              max_numharm=8, topk=16)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    before = cuda_dd.LAUNCHES["accel_stage"]
    row, row_peak = peak(lambda: accel.accel_row_topk(specs, bf, 1, **kw))
    assert cuda_dd.LAUNCHES["accel_stage"] == before + 1
    one = accel.accel_chunk_topk(specs, bf, 1, nrows=1, **kw)
    for r, b in zip(row, one, strict=True):
        assert torch.equal(r, b[0])
    _batch, batch_peak = peak(lambda: accel.accel_chunk_topk(
        specs, bf, 0, nrows=2, **kw))
    assert row_peak < batch_peak

    def counts():
        return (telemetry.accel_kernel_rows_total().value(),
                telemetry.accel_batch_trials_total().value(path="batched"))

    k0, b0 = counts()
    accel.accel_search_batch(specs[:3], bank, max_numharm=8, topk=16,
                             dm_chunk=2)
    k1, b1 = counts()
    assert k1 - k0 == b1 - b0 == 3
