"""PyTorch port, the exact identities K6 (``csrc/int8_attention.cu``) rests
on, checked in numpy and torch on the CPU (vectorised, a few seconds):

* the row max of x = T(float32(s) * c) is x(max s), so the kernel takes the
  max of the int32 scores and forms m once a row;
* an int32 accumulator started at the bits of 1.5 * 2^23 holds the float
  12582912 + s, and one float subtraction gives float32(s) exactly, for
  every |s| <= 127^2 * 128 (int8 codes at D <= 128);
* rint by an add: y + 128 rounded to bf16 is 0x4300 + rint(y) for every bf16
  y in [0, 127], and y + 1.5 * 2^23 rounded to float32 holds rint(y) in its
  low byte, both ties to even as ``torch.round``; the float32 product of a
  bf16 p in [0, 1] by 127 is exact, so one bf16 rounding of it is what
  PyTorch computes;
* the quantize launch clamps before it rounds: the same codes as rounding
  first."""
import numpy as np
import pytest
import torch

MAGIC = 0x4B400000  # the bits of 1.5 * 2^23
MAGIC_F = np.float32(12582912.0)
S_MAX = 127 ** 2 * 128


def _bf16_values(lo, hi):
    """Every bf16 value in [lo, hi] (lo, hi >= 0), ascending, as a bf16 tensor."""
    bits = torch.arange(0, 0x7F80, dtype=torch.int32).to(torch.int16)
    vals = bits.view(torch.bfloat16)
    return vals[(vals.float() >= lo) & (vals.float() <= hi)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row_max_of_the_scaled_scores_is_the_scaled_max_score(dtype):
    """x = dtype(float32(s) * c) is non-decreasing in s for c > 0, so the max
    ``torch.softmax`` subtracts equals x(max s). Rows of random scores at
    random scales, rows whose top scores fall on one bf16 value (ties after
    the rounding), rows of one repeated score and rows of negative scores."""
    rng = np.random.RandomState(0)
    rows, keys = 4096, 97
    s = rng.randint(-S_MAX, S_MAX + 1, (rows, keys)).astype(np.int32)
    s[:512] = rng.randint(1_000_000, 1_000_040, (512, keys))  # many ties after rounding
    s[512:640] = s[512:640, :1]                               # one repeated score
    s[640:1024] = -np.abs(s[640:1024])                        # negative rows
    c = (10.0 ** rng.uniform(-9, -1, (rows, 1))).astype(np.float32)
    st, ct = torch.from_numpy(s), torch.from_numpy(c)
    x = (st.float() * ct).to(dtype)
    want = x.float().max(dim=-1).values
    got = (st.max(dim=-1).values.float() * ct[:, 0]).to(dtype).float()
    assert torch.equal(got, want)
    ties = (x[:512] == x[:512].max(dim=-1, keepdim=True).values).sum(-1)
    if dtype == torch.bfloat16:
        assert (ties > 1).all()  # the case is exercised


def test_magic_number_conversion_is_exact_for_every_score():
    """Every int8 score of D <= 128, |s| <= 127^2 * 128 (< 2^22): the int32
    MAGIC + s, read as a float, less 12582912 is float32(s); the biased
    accumulators are positive and in the order of s, so their integer max is
    the max score and a key left out as 0 never wins it."""
    s = np.arange(-S_MAX, S_MAX + 1, dtype=np.int32)
    biased = s + np.int32(MAGIC)
    assert np.array_equal(biased.view(np.float32) - MAGIC_F, s.astype(np.float32))
    assert biased.min() > 0 and (np.diff(biased) == 1).all()
    assert 127 ** 2 * 128 < 2 ** 22


def test_rint_by_an_add_in_bf16():
    """For every bf16 y in [0, 127]: y + 128 rounded to bf16 is 0x4300 +
    rint(y) (ties to even), so the code is the low byte; and for every bf16
    p in [0, 1], float32(p) * 127 is exact, so T(p * 127) is p * 127 rounded
    once to bf16, as a bf16x2 product rounds it."""
    y = _bf16_values(0.0, 127.0)
    assert y.numel() > 16000
    z = (y + torch.tensor(128.0, dtype=torch.bfloat16)).view(torch.int16).int()
    code = torch.round(y).to(torch.int8)
    assert torch.equal(z - 0x4300, code.int())
    assert torch.equal((z & 0xFF).to(torch.int8), code)
    p = _bf16_values(0.0, 1.0)
    assert torch.equal((p.float() * 127).double(), p.double() * 127)
    assert torch.equal(p * 127, (p.double() * 127).to(torch.bfloat16))


def test_rint_by_an_add_in_float32():
    """y + 1.5 * 2^23 rounded to float32 holds rint(y) in its low byte for y
    in [0, 127]: every half k + 1/2, the floats next to each half, and random
    values, against ``torch.round`` (ties to even)."""
    half = np.arange(0, 127, dtype=np.float32) + np.float32(0.5)
    near = np.concatenate([np.nextafter(half, np.float32(0)), np.nextafter(half, np.float32(200))])
    rand = np.random.RandomState(1).uniform(0, 127, 100_000).astype(np.float32)
    y = np.concatenate([half, near, rand, np.float32([0, 127])])
    low = ((y + MAGIC_F).view(np.uint32) & 0xFF).astype(np.int8)
    assert np.array_equal(low, torch.round(torch.from_numpy(y)).to(torch.int8).numpy())
    assert np.array_equal(low[:127], (np.arange(127) + (np.arange(127) % 2)).astype(np.int8))


def test_clamp_before_rint_gives_the_same_codes():
    """``_act_quantize`` rounds, then clamps to +-127; the quantize launch
    clamps, then rounds: the same codes on halves, their neighbours and
    values far past the clamp."""
    k = np.arange(-300, 300, dtype=np.float32) + np.float32(0.5)
    y = torch.from_numpy(np.concatenate([k, np.nextafter(k, np.float32(0)),
                                         np.float32([1e30, -1e30, 127.49, -127.51])]))
    assert torch.equal(torch.round(y).clamp(-127, 127).to(torch.int8),
                       torch.round(y.clamp(-127, 127)).to(torch.int8))
