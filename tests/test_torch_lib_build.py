"""The kernel library's build cache (``repro_torch/kernels/_lib.py::build``):
a library already built is reused together with nvcc's report of its build,
which the card checks read (ptxas registers and spills). Runs on the CPU:
nvcc is never reached."""
import pytest

from repro_torch.kernels import _lib

VERBOSE = ("-Xptxas", "-v")


class NvccCalled(Exception):
    pass


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    def no_nvcc():
        raise NvccCalled

    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "BUILD_LOG", "")
    monkeypatch.setattr(_lib, "VARIANT_LOGS", {})
    monkeypatch.setattr(_lib, "_nvcc", no_nvcc)
    return tmp_path


def _built(build_dir, defines, report):
    extra = VERBOSE + tuple(f"-D{d}" for d in defines)
    lib_path = build_dir / f"libsnapmla_{_lib._digest(extra)}.so"
    lib_path.write_bytes(b"\x7fELF")
    if report is not None:
        lib_path.with_suffix(".log").write_text(report)
    return lib_path


@pytest.mark.parametrize("defines", [(), ("SNAPMLA_NO_VERIFY",)])
def test_a_reused_build_reads_back_its_report(build_dir, defines):
    report = "== gqa_decode.cu\nptxas info    : Used 123 registers, 0 bytes spill stores\n"
    lib_path = _built(build_dir, defines, report)
    assert _lib.build(verbose=True, defines=defines) == lib_path
    if defines:
        assert _lib.VARIANT_LOGS[defines] == report and _lib.BUILD_LOG == ""
    else:
        assert _lib.BUILD_LOG == report and _lib.VARIANT_LOGS == {}


def test_a_library_without_its_report_is_rebuilt(build_dir):
    _built(build_dir, (), None)
    with pytest.raises(NvccCalled):
        _lib.build(verbose=True)
    assert _lib.BUILD_LOG == ""
