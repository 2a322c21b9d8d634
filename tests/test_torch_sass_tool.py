"""``tools/sass_loops.py``, the SASS instruction counter that the port's
kernel notes and ``PERF.md`` take their per-entry counts from: its parsing
of a ``cuobjdump -sass`` listing, its classes and its loop spans, on a
synthetic listing (the CPU has no CUDA toolkit)."""
import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / 'tools' / 'sass_loops.py'
_spec = importlib.util.spec_from_file_location('sass_loops', _PATH)
sass_loops = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sass_loops)

LISTING = """
	code for sm_90a
		Function : _ZN49_GLOBAL__N__3821bf21_16_matern52_gram_cu_468a112711gram_kernelIdLi8EN4lcgp8Matern52EEEvPKT_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
.L_x_3:
        /*0010*/                   DFMA R2, R4, R6, R2 ;
        /*0020*/              @!P0 MUFU.RCP64H R3, R5 ;
        /*0030*/                   F2F.F64.F32 R8, R9 ;
        /*0040*/                   LDS.64 R10, [R12] ;
        /*0050*/                   UBLKCP.S.G [UR4], [UR6], UR8 ;
        /*0060*/               @P1 BRA `(.L_x_3) ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/                   BRA 0x70 ;
		Function : _Z3fooIfLi4EN4lcgp2SEEEv
        /*0000*/                   FFMA R0, R1, R2, R3 ;
        /*0010*/                   STG.E [R4.64], R0 ;
"""


def test_functions_and_labels_are_parsed():
    funcs, labels = sass_loops.functions(LISTING)
    assert len(funcs) == 2
    name = next(iter(funcs))
    assert [op for _, op, _, _ in funcs[name]][:3] == ['LDC', 'DFMA', 'MUFU']
    assert labels[name] == {'.L_x_3': 0x10}


def test_loops_are_the_backward_branches():
    funcs, labels = sass_loops.functions(LISTING)
    name = next(iter(funcs))
    # a label target and a hex target, both backward
    assert sass_loops.loops(funcs[name], labels[name]) == [(0x10, 0x60),
                                                           (0x70, 0x80)]


@pytest.mark.parametrize('op,mods,cls', [
    ('DFMA', '', 'f64'), ('MUFU', '.RCP64H', 'f64'), ('MUFU', '.EX2', 'fp32'),
    ('F2F', '.F64.F32', 'f2f'), ('LDS', '.64', 'lds'), ('STG', '.E', 'stg'),
    ('UBLKCP', '.S.G', 'async'), ('SYNCS', '.ARRIVE', 'async'),
    ('BAR', '.SYNC', 'bar'), ('IMAD', '', 'other')])
def test_classes(op, mods, cls):
    assert sass_loops.classify(op, mods) == cls


def test_counts_of_a_span():
    funcs, labels = sass_loops.functions(LISTING)
    name = next(iter(funcs))
    got = sass_loops.counts(funcs[name], 0x10, 0x60)
    assert got == {'f64': 2, 'f2f': 1, 'lds': 1, 'async': 1, 'other': 1,
                   'all': 6}


@pytest.mark.parametrize('mangled,short', [
    ('_ZN49_GLOBAL__N__3821bf21_16_matern52_gram_cu_468a112711gram_kernel'
     'IdLi8EN4lcgp8Matern52EEEvPKT_', 'gram_kernel<double, 8, Matern52>'),
    ('_ZN53_GLOBAL__N__9fb23d52_20_matern52_gram_vjp_cu_99eb72d519'
     'gram_vjp_tma_kernelIfLi16EN4lcgp8Matern52EEEvPKT_',
     'gram_vjp_tma_kernel<float, 16, Matern52>'),
    ('_Z3fooIfLi4EN4lcgp2SEEEv', '_Z3fooIfLi4EN4lcgp2SEEEv')])
def test_short_names(mangled, short):
    assert sass_loops.short_name(mangled) == short
