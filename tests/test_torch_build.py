"""The kernel build's register and spill report.

``katib_tpu_torch.ops._build`` compiles each CUDA source with ``ptxas -v``
and keeps the compiler's log beside the library; ``chip_smoke.py`` reads
``ptxas_report`` from it and fails when a flash kernel spills.  Here the
parser reads logs in the two forms ``ptxas`` writes them (demangled and
mangled entry names); no compiler runs.
"""

from __future__ import annotations

import pytest

from katib_tpu_torch.ops import _build

_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'
ptxas info    : Function properties for {fwd}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 133 registers, used 1 barriers
ptxas info    : Compile time = 412.5 ms
ptxas info    : Compiling entry function '{scalar}' for 'sm_90a'
ptxas info    : Function properties for {scalar}
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 8 bytes cumulative stack size
"""
_DEMANGLED = {
    "fwd": "void (anonymous namespace)::flash_fwd_kernel<64>(__nv_bfloat16 const*, "
           "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, int, int, "
           "float, int)",
    "scalar": "void (anonymous namespace)::mixed_op_scalar_kernel<__nv_bfloat16>("
              "float const*, __nv_bfloat16 const*, __nv_bfloat16*, int, long)",
}
_MANGLED = {
    "fwd": "_ZN12_GLOBAL__N_116flash_fwd_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiifi",
    "scalar": "_ZN12_GLOBAL__N_122mixed_op_scalar_kernelI13__nv_bfloat16EEvPKfPKT_PS4_il",
}


@pytest.fixture
def log_at(tmp_path, monkeypatch):
    """Writes a compiler log where ``ptxas_report("flash_attention")``
    looks for it."""
    lib = tmp_path / "libflash_attention-0123456789ab.so"
    monkeypatch.setattr(_build, "library_path", lambda name: lib)

    def write(names):
        lib.with_suffix(".log").write_text(_LOG.format(**names))

    return write


def test_report_reads_registers_and_spills_of_demangled_entries(log_at):
    log_at(_DEMANGLED)
    assert _build.ptxas_report("flash_attention") == {
        "flash_fwd_kernel<64>": (133, 0),
        "mixed_op_scalar_kernel<__nv_bfloat16>": (80, 8),
    }


def test_report_keeps_mangled_entries_it_cannot_demangle(log_at, monkeypatch):
    monkeypatch.setattr(_build, "_demangle", lambda names: names)
    log_at(_MANGLED)
    assert _build.ptxas_report("flash_attention") == {
        _MANGLED["fwd"]: (133, 0),
        _MANGLED["scalar"]: (80, 8),
    }
