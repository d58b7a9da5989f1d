"""The CUDA sources and their build, held to the parity rules the kernels
depend on. CPU only: nothing here compiles or launches a kernel.

- the build targets sm_90a and never passes --use_fast_math, so logf,
  cosf, sqrtf and expf stay the precise versions;
- no code line under csrc/ calls a fast-math intrinsic or reaches the
  tensor cores (TF32, mma.sync, wgmma), which would break the bitwise
  identity probe and the parity tolerances against cuBLAS SGEMM;
- every kernel that draws z includes the one counter-hash header;
- a library is rebuilt when a shared header changes;
- each ctypes binding matches its C entry point, argument for argument,
  and perturbed_matmul's wrapper has the cluster size of its source.
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

FORBIDDEN = ("__expf", "__logf", "__cosf", "__sinf", "tf32", "mma.sync",
             "wgmma")
SOURCE_FILES = sorted(p.name for p in build.CSRC.iterdir()
                      if p.suffix in (".cu", ".cuh"))


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


@pytest.mark.parametrize("fname", SOURCE_FILES)
def test_no_fast_math_or_tensor_core_calls(fname):
    lines = _code_lines((build.CSRC / fname).read_text())
    hits = [(i + 1, word) for i, line in enumerate(lines)
            for word in FORBIDDEN if word in line]
    assert not hits, f"{fname}: {hits}"


def test_comment_stripping_keeps_code():
    """The checker sees code next to a comment, and only code."""
    lines = _code_lines("x = __expf(y); // wgmma later\n/* tf32\n */ z;\n")
    assert "__expf" in lines[0] and "wgmma" not in lines[0]
    assert not any("tf32" in line for line in lines)
    assert "z;" in lines[2]


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
    CLUSTER; the kernel's grid and draws use kCluster."""
    code = "\n".join(_code_lines(
        (build.CSRC / "perturbed_matmul.cu").read_text()))
    found = re.findall(r"constexpr int kCluster = (\d+);", code)
    assert found == [str(pmm.CLUSTER)]
    assert re.findall(r"constexpr int BM = (\d+);", code) == [str(pmm.BM)]


def test_perturbed_matmul_rejects_too_many_row_blocks_before_launch():
    torch = pytest.importorskip("torch")
    m = 65535 * pmm.BM + 1
    x = torch.zeros((m, 4), device="meta")
    w = torch.zeros((4, 4), device="meta")
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
