"""The CUDA sources and their build, held to the parity rules the kernels
depend on. CPU only: nothing here compiles or launches a kernel.

- the build targets sm_90a and never passes --use_fast_math, so logf,
  cosf, sqrtf and expf stay the precise versions;
- no code line under csrc/ calls a fast-math intrinsic or uses wgmma;
- no code line reaches the tensor cores (TF32, mma.sync) but inside the
  named helpers: flash_attention.cu's 3xTF32 `tc_split` and `tc_mma3`,
  which issue exactly three mma.sync a product (lo.hi, hi.lo, hi.hi),
  its bf16 `bf16_mma_qk` (one mma.sync a k-step of Q·Kᵀ), `bf16_split2`
  (none) and `bf16_mma2` (two, P's lo piece then its hi piece), called
  by the bf16 kernel alone, which calls no other tensor-core helper,
  and perturbed_matmul.cu's bf16 `bf16_split3` and `bf16_mma3`, which
  issue exactly three bf16 mma.sync a product (x.lo, x.mid, x.hi) and
  only from the bf16 kernel: the f32 perturbed_matmul and seeded_axpy
  keep f32 FMA for their bitwise identity probe and their parity with
  cuBLAS SGEMM, flash attention's 3xTF32 is held to the flash gate on the
  card, and perturbed_matmul_bf16's three pieces carry w + eps·z's 24
  bits, so its identity probe stays bitwise;
- every kernel that draws z includes the one counter-hash header;
- a library is rebuilt when a shared header changes;
- each ctypes binding matches its C entry point, argument for argument,
  and perturbed_matmul's wrapper has the cluster size and block rows of
  its source for each dtype.
"""
import ctypes
import re
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import perturbed_matmul as pmm  # noqa: E402
from repro_torch.kernels import rglru_scan  # noqa: E402
from repro_torch.kernels import seeded_axpy as sa  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

FAST_MATH = ("__expf", "__logf", "__cosf", "__sinf")
# TF32 operands, PTX's mma.sync / mma.sp, the C++ wmma API, and wgmma
TENSOR_CORES = ("tf32", "mma.", "wmma", "wgmma")
FORBIDDEN = FAST_MATH + TENSOR_CORES
SOURCE_FILES = sorted(p.name for p in build.CSRC.iterdir()
                      if p.suffix in (".cu", ".cuh"))
# the only code allowed on the tensor cores: (file, helper)
TC_HELPERS = (("flash_attention.cu", "tc_split"),
              ("flash_attention.cu", "tc_mma3"),
              ("flash_attention.cu", "bf16_mma_qk"),
              ("flash_attention.cu", "bf16_split2"),
              ("flash_attention.cu", "bf16_mma2"),
              ("perturbed_matmul.cu", "bf16_split3"),
              ("perturbed_matmul.cu", "bf16_mma3"))


def _code_lines(text: str):
    """The source's lines with // and /* */ comments removed."""
    text = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"),
                  text, flags=re.S)
    return [line.split("//", 1)[0] for line in text.splitlines()]


def test_nvcc_flags_target_sm90a_without_fast_math():
    flags = build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    assert not any(f.startswith("-ftz") or f.startswith("-prec")
                   for f in flags)


@pytest.mark.parametrize("name", build.SOURCES)
def test_every_source_has_its_cu(name):
    assert (build.CSRC / f"{name}.cu").is_file()
    assert build.library_path(name).name.startswith(f"lib{name}-")


def _helper_span(lines, name: str) -> range:
    """The code lines of `__device__ ... name(...) { ... }`, from its
    signature to its closing brace."""
    start = next(i for i, line in enumerate(lines)
                 if re.search(rf"__device__ .*\b{name}\(", line))
    return _braced_from(lines, start, name)


def _kernel_span(lines, name: str) -> range:
    """The code lines of the kernel `name(...) { ... }`, from the line that
    opens its parameter list (`name(` at the line's start) to its closing
    brace."""
    start = next(i for i, line in enumerate(lines)
                 if re.match(rf"{name}\(", line))
    return _braced_from(lines, start, name)


def _braced_from(lines, start: int, name: str) -> range:
    """Lines start.. through the brace that closes the first one opened."""
    depth, seen = 0, False
    for i in range(start, len(lines)):
        depth += lines[i].count("{") - lines[i].count("}")
        seen = seen or "{" in lines[i]
        if seen and depth == 0:
            return range(start, i + 1)
    raise AssertionError(f"{name}: no closing brace")


@pytest.mark.parametrize("fname", SOURCE_FILES)
def test_no_fast_math_or_tensor_core_calls(fname):
    """Fast-math intrinsics and wgmma nowhere; TF32 and mma only inside
    the named 3xTF32 helpers."""
    lines = _code_lines((build.CSRC / fname).read_text())
    inside = set()
    for f, helper in TC_HELPERS:
        if f == fname:
            inside.update(_helper_span(lines, helper))
    hits = [(i + 1, word) for i, line in enumerate(lines)
            for word in (FAST_MATH + ("wgmma",) if i in inside else FORBIDDEN)
            if word in line]
    assert not hits, f"{fname}: {hits}"


def test_tensor_core_helpers_issue_three_passes():
    """tc_mma3 is three mma.sync m16n8k8 TF32 products into one f32
    accumulator, small terms first: lo.hi, hi.lo, hi.hi; tc_split issues
    none; the tensor-core kernel calls tc_mma3 and nothing else on the
    tensor cores."""
    lines = _code_lines((build.CSRC / "flash_attention.cu").read_text())
    mma3 = "\n".join(lines[i] for i in _helper_span(lines, "tc_mma3"))
    split = "\n".join(lines[i] for i in _helper_span(lines, "tc_split"))
    assert mma3.count("mma.sync") == 3
    assert mma3.count("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32") == 3
    operands = re.findall(r'"r"\((a[hl])\[0\]\).*?"r"\((b[hl])\[0\]\)', mma3,
                          flags=re.S)
    assert operands == [("al", "bh"), ("ah", "bl"), ("ah", "bh")]
    assert "mma" not in split
    # hi rounded to TF32 (10 mantissa bits, to nearest), lo = x - hi
    assert "0xffffe000u" in split and "x - __uint_as_float(hi)" in split
    kernel = "\n".join(lines)
    assert "tc_mma3(" in kernel[kernel.index("flash_fwd_tc_kernel("):]


def test_bf16_tensor_core_helpers_issue_three_passes():
    """perturbed_matmul.cu's bf16_mma3 is three mma.sync m16n8k16 bf16
    products into f32 accumulators, the pieces small first: x.lo, x.mid,
    x.hi; bf16_split3 issues none (hi rounded to nearest even, mid and lo
    toward zero); the bf16 kernel splits with bf16_split3 and multiplies
    through bf16_mma3; and the f32 kernel pmm_kernel<float> reaches no
    tensor-core helper."""
    lines = _code_lines((build.CSRC / "perturbed_matmul.cu").read_text())
    mma3 = "\n".join(lines[i] for i in _helper_span(lines, "bf16_mma3"))
    split = "\n".join(lines[i] for i in _helper_span(lines, "bf16_split3"))
    assert mma3.count("mma.sync") == 3
    assert mma3.count(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32") == 3
    assert re.findall(r'"r"\((b\w+)\[0\]\)', mma3) == ["blo", "bmid", "bhi"]
    assert "mma" not in split
    assert split.count("__float2bfloat16_rn(") == 2
    assert split.count("__float2bfloat16_rz(") == 4
    bf16_kernel = "\n".join(lines[i]
                            for i in _kernel_span(lines, "pmm_kernel_bf16"))
    assert "bf16_mma3(" in bf16_kernel and "bf16_split3(" in bf16_kernel
    f32_kernel = "\n".join(lines[i] for i in _kernel_span(lines, "pmm_kernel"))
    assert "Elem" in f32_kernel and "fmaf(" in f32_kernel
    for word in ("mma", "ldsm", "ldmatrix", "split3", "tc_split"):
        assert word not in f32_kernel, word


BF16_MMA = "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
# flash_attention.cu's kernels: the bf16 one, and the f32 ones
FLASH_BF16_KERNEL = "flash_fwd_bf16_kernel"
FLASH_F32_KERNELS = ("flash_fwd_small_kernel", "flash_fwd_tc_kernel",
                     "flash_fwd_group_kernel")


@pytest.mark.parametrize("helper,passes", [("bf16_mma_qk", 1),
                                           ("bf16_split2", 0),
                                           ("bf16_mma2", 2)])
def test_flash_bf16_helpers_issue_their_passes(helper, passes):
    """flash_attention.cu's bf16 helpers: bf16_mma_qk one bf16 mma.sync
    m16n8k16 (a k-step of Q·Kᵀ, summed from zero and added in f32),
    bf16_split2 none (P's hi and lo pieces, each rounded to nearest even),
    bf16_mma2 two into one f32 accumulator, lo first, then hi."""
    lines = _code_lines((build.CSRC / "flash_attention.cu").read_text())
    body = "\n".join(lines[i] for i in _helper_span(lines, helper))
    assert body.count("mma.sync") == passes
    assert body.count(BF16_MMA) == passes
    if helper == "bf16_mma_qk":
        # from zero, then added to the scores in f32
        assert "z[4] = {0.0f, 0.0f, 0.0f, 0.0f}" in body
        assert "s[e] += z[e]" in body
    if helper == "bf16_split2":
        assert body.count("__floats2bfloat162_rn(") == 2
        assert body.count("__fsub_rn(") == 2
    if helper == "bf16_mma2":
        assert re.findall(r'"r"\((p[hl])\[0\]\)', body) == ["pl", "ph"]


def test_flash_bf16_kernel_calls_only_its_helpers():
    """The bf16 kernel multiplies through bf16_mma_qk and bf16_mma2 (after
    bf16_split2) and reaches no 3xTF32 helper; no f32 kernel reaches a bf16
    helper."""
    lines = _code_lines((build.CSRC / "flash_attention.cu").read_text())
    bf16 = "\n".join(lines[i] for i in _kernel_span(lines, FLASH_BF16_KERNEL))
    for call in ("bf16_mma_qk(", "bf16_split2(", "bf16_mma2("):
        assert call in bf16, call
    for word in ("tc_mma3", "tc_split", "tf32"):
        assert word not in bf16, word
    for name in FLASH_F32_KERNELS:
        body = "\n".join(lines[i] for i in _kernel_span(lines, name))
        for word in ("bf16_mma_qk", "bf16_split2", "bf16_mma2", "ldsm_x4",
                     "quotient_rn"):
            assert word not in body, (name, word)


@pytest.mark.parametrize("d", fa.BF16_HEAD_DIMS)
def test_flash_bf16_entry_points_take_the_bf16_kernel(d):
    """flash_attention_bf16 launches flash_fwd_bf16_kernel<d> at each bf16
    head dim, and flash_attention_bf16_attributes reports it; neither
    reaches the f32 kernels' launches."""
    code = "\n".join(_code_lines((build.CSRC / "flash_attention.cu")
                                 .read_text())) + "\n"

    def body(entry):
        start = code.index(f'extern "C" int {entry}(')
        return code[start:code.index("\n}\n", start)]

    launch = body("flash_attention_bf16")
    attrs = body("flash_attention_bf16_attributes")
    assert f"case {d}: return launch_bf16<{d}>(" in launch
    assert f"case {d}: return bf16_attributes<{d}>(info);" in attrs
    for word in ("launch_small", "launch_tc", "launch_group"):
        assert word not in launch
    assert "flash_fwd_bf16_kernel<D>" in code[code.index("int launch_bf16("):]


def test_tf32_rounding_helper_rounds_as_cvt_rna():
    """tc_split's hi, (bits + 0x1000) & 0xffffe000, is round to nearest
    with ties away from zero at 10 mantissa bits, as cvt.rna.tf32.f32:
    checked here on float32 values against that rounding done in float64,
    and lo = x - hi is exact."""
    np = pytest.importorskip("numpy")
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 8,
                        np.float32([1.0, -1.0, 0.0, 3.0e38, 1.5e-38]),
                        # ties: exactly half a TF32 ulp above a TF32 value
                        np.array([0x3F801000, 0xBF801000, 0x40003000],
                                 dtype=np.uint32).view(np.float32)])
    hi = ((x.view(np.uint32) + np.uint32(0x1000))
          & np.uint32(0xFFFFE000)).view(np.float32)
    exp = np.floor(np.log2(np.abs(x.astype(np.float64)),
                           where=x != 0, out=np.zeros(x.shape)))
    ulp = np.exp2(exp - 10)
    want = np.sign(x) * np.floor(np.abs(x.astype(np.float64)) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(hi.astype(np.float64), want)
    lo = x - hi
    np.testing.assert_array_equal(hi.astype(np.float64) + lo.astype(np.float64),
                                  x.astype(np.float64))


def test_comment_stripping_keeps_code():
    """The checker sees code next to a comment, and only code."""
    lines = _code_lines("x = __expf(y); // wgmma later\n/* tf32\n */ z;\n")
    assert "__expf" in lines[0] and "wgmma" not in lines[0]
    assert not any("tf32" in line for line in lines)
    assert "z;" in lines[2]


def test_helper_span_covers_the_body_only():
    """The tensor-core exemption covers a helper's braces and nothing
    past them."""
    lines = _code_lines("int a;\n__device__ inline void tc_mma3(float c) {\n"
                        "  if (c) { mma.sync; }\n}\nmma.sync;\n")
    assert list(_helper_span(lines, "tc_mma3")) == [1, 2, 3]


@pytest.mark.parametrize("name", ["perturbed_matmul", "seeded_axpy"])
def test_z_drawing_kernels_share_the_counter_hash(name):
    src = (build.CSRC / f"{name}.cu").read_text()
    assert '#include "counter_hash.cuh"' in src
    code = "\n".join(_code_lines(src))
    assert "counter_hash::" in code


def test_library_path_tracks_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = csrc / "counter_hash.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
    # and an edited source changes its own library only
    src = csrc / "perturbed_matmul.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {name: build.library_path(name) for name in build.SOURCES}
    assert again["perturbed_matmul"] != after["perturbed_matmul"]
    assert all(again[n] == after[n] for n in build.SOURCES
               if n != "perturbed_matmul")


_CTYPE = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
          "unsigned int": ctypes.c_uint, "long long": ctypes.c_longlong,
          "float": ctypes.c_float}


def _c_signatures():
    """Every extern "C" entry point under csrc/: name -> argument ctypes."""
    out = {}
    for path in build.CSRC.glob("*.cu"):
        code = "\n".join(_code_lines(path.read_text()))
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', code):
            types = []
            for arg in args.split(","):
                decl = " ".join(arg.split()[:-1]) if "*" not in arg else "ptr"
                types.append(_CTYPE[decl.replace("const ", "")])
            out[name] = types
    return out


class _FakeFn:
    def __call__(self, *args):
        return 0


class _FakeLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _FakeFn())


def test_ctypes_bindings_match_c_entry_points(monkeypatch):
    """A pointer passed as c_int would be cut to 32 bits: every binding
    names each C argument's type, in order."""
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name: lib)
    for mod in (sa, fa, pmm, ssd_scan, rglru_scan):
        mod._lib()
    attrs = pmm.kernel_attributes(2560, 768)
    assert set(attrs) >= {"registers", "local_bytes", "cluster"}
    ssd_attrs = ssd_scan.kernel_attributes(64)
    assert len(ssd_attrs) == 3
    assert all(set(a) >= {"registers", "local_bytes", "dynamic_smem"}
               for a in ssd_attrs.values())
    fa_attrs = fa.kernel_attributes(256)
    assert set(fa_attrs) >= {"registers", "local_bytes", "dynamic_smem",
                             "blocks_per_sm", "threads", "rows", "key_tile"}
    sigs = _c_signatures()
    assert set(lib.fns) >= {"seeded_axpy_f32", "seeded_gather_f32",
                            "flash_attention_f32",
                            "flash_attention_attributes",
                            "perturbed_matmul_f32",
                            "perturbed_matmul_attributes", "ssd_scan_f32",
                            "ssd_scan_attributes", "rglru_scan_f32"}
    for name, fn in lib.fns.items():
        assert fn.argtypes == sigs[name], name
        assert fn.restype is ctypes.c_int, name


def test_perturbed_matmul_cluster_matches_its_source():
    """The wrapper's row-block limit and the drawn-tile accounting use
    CLUSTER and BM per dtype; the kernels' grids and draws use kCluster and
    BM (f32) and kTcCluster and kTcBM (bf16)."""
    torch = pytest.importorskip("torch")
    code = "\n".join(_code_lines(
        (build.CSRC / "perturbed_matmul.cu").read_text()))
    assert set(pmm.CLUSTER) == set(pmm.BM) == set(build.SUFFIX)
    for dtype, cluster, bm in ((torch.float32, "kCluster", "BM"),
                               (torch.bfloat16, "kTcCluster", "kTcBM")):
        found = re.findall(rf"constexpr int {cluster} = (\d+);", code)
        assert found == [str(pmm.CLUSTER[dtype])]
        found = re.findall(rf"constexpr int {bm} = (\d+);", code)
        assert found == [str(pmm.BM[dtype])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perturbed_matmul_rejects_too_many_row_blocks_before_launch(dtype):
    torch = pytest.importorskip("torch")
    dtype = getattr(torch, dtype)
    m = 65535 * pmm.BM[dtype] + 1
    x = torch.zeros((m, 4), dtype=dtype, device="meta")
    w = torch.zeros((4, 4), dtype=dtype, device="meta")
    eps = torch.zeros((), device="meta")
    seed = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="65535 row blocks"):
        pmm.perturbed_matmul_cuda(x, w, seed, 0, eps)


@pytest.mark.parametrize("q_shape,kv_shape,match", [
    # head_dim 320: above the largest instance, 256 (ROADMAP B3)
    ((2, 4, 8, 320), (2, 4, 8, 320), "head_dim 320"),
    # k's head_dim differs from q's
    ((2, 4, 8, 256), (2, 4, 8, 64), "do not line up"),
    # 10 q heads on 3 kv heads
    ((2, 10, 8, 256), (2, 3, 8, 256), "Hq % Hkv"),
])
def test_flash_attention_rejects_before_any_library_load(monkeypatch, q_shape,
                                                         kv_shape, match):
    """Shapes the kernel does not take raise in the wrapper, before nvcc
    or the library is touched."""
    torch = pytest.importorskip("torch")

    def no_load(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", no_load)
    q = torch.zeros(q_shape, device="meta")
    k = torch.zeros(kv_shape, device="meta")
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_cuda(q, k, k.clone())
