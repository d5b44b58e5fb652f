"""ParseHeader grammar + Parameters validation tests."""

import pytest

from zeldovich.utils.parseheader import (
    DONT_CARE,
    MUST_DEFINE,
    ParseError,
    ParseHeader,
    PHType,
)
from zeldovich.utils.params import ParameterError, Parameters

BASE = {
    "BoxSize": 100.0,
    "NP": 64**3,
    "CPD": 100,
    "ICFormat": "RVZel",
    "InitialConditionsDirectory": "/tmp/ic_out",
    "InitialRedshift": 49.0,
    "ZD_Seed": 12346,
    "ZD_NumBlock": 2,
    "ZD_Pk_scale": 1.0,
    "ZD_Pk_norm": 8.0,
    "ZD_Pk_smooth": 0.0,
    "ZD_Pk_sigma": 0.02,
    "ZD_Pk_filename": "wmap1new.pow",
    "ZD_Version": 2,
}


def write_par(tmp_path, overrides=None, drop=()):
    d = dict(BASE)
    d.update(overrides or {})
    for k in drop:
        d.pop(k, None)
    lines = []
    for k, v in d.items():
        if isinstance(v, str):
            lines.append(f'{k} = "{v}"')
        elif isinstance(v, (list, tuple)):
            lines.append(f"{k} = {' '.join(map(str, v))}")
        else:
            lines.append(f"{k} = {v}")
    p = tmp_path / "test.par"
    p.write_text("\n".join(lines) + "\n")
    return p


class TestGrammar:
    def parse(self, text, **installs):
        ph = ParseHeader()
        for name, type_ in installs.items():
            ph.install(name, type_, DONT_CARE)
        ph.parse_string(text)
        return ph

    def test_basic_types(self):
        ph = self.parse(
            "a = 3\nb = 2.5\nc = \"hello world\"\nd = 'single'\ne = bare_id.ext\n",
            a=PHType.INT,
            b=PHType.DOUBLE,
            c=PHType.STRING,
            d=PHType.STRING,
            e=PHType.STRING,
        )
        assert ph["a"] == 3
        assert ph["b"] == 2.5
        assert ph["c"] == "hello world"
        assert ph["d"] == "single"
        assert ph["e"] == "bare_id.ext"

    def test_int_coerces_to_double(self):
        ph = self.parse("x = 7\n", x=PHType.DOUBLE)
        assert ph["x"] == 7.0 and isinstance(ph["x"], float)

    def test_float_rejected_for_int(self):
        with pytest.raises(ParseError):
            self.parse("x = 7.5\n", x=PHType.INT)

    def test_fortran_floats(self):
        ph = self.parse(
            "a = 1e21\nb = 1D+3\nc = 1.5d-2\nd = .5\ne = 5.\nf = 1.5+3\n",
            a=PHType.DOUBLE,
            b=PHType.DOUBLE,
            c=PHType.DOUBLE,
            d=PHType.DOUBLE,
            e=PHType.DOUBLE,
            f=PHType.DOUBLE,
        )
        assert ph["a"] == 1e21
        assert ph["b"] == 1e3
        assert ph["c"] == 1.5e-2
        assert ph["d"] == 0.5
        assert ph["e"] == 5.0
        assert ph["f"] == 1.5e3

    def test_booleans(self):
        ph = self.parse("a = true\nb = false\n", a=PHType.INT, b=PHType.INT)
        assert ph["a"] == 1 and ph["b"] == 0

    def test_comments_and_continuation(self):
        text = (
            "# full line comment\n"
            "a = 1  # trailing comment\n"
            "##\nthis is a block comment\nstill comment b = 9\n##\n"
            "b = \\\n   2\n"
            'c = "has # not a comment"\n'
        )
        ph = self.parse(text, a=PHType.INT, b=PHType.INT, c=PHType.STRING)
        assert ph["a"] == 1
        assert ph["b"] == 2
        assert ph["c"] == "has # not a comment"

    def test_vector(self):
        ph = self.parse("v = 1 -2 3\n", v=PHType.INT_VECTOR)
        assert ph["v"] == [1, -2, 3]

    def test_unknown_keys_ignored(self):
        ph = self.parse("someAbacusKey = 42\nanother = \"x\"\n")
        # no error

    def test_must_define_enforced(self):
        ph = ParseHeader()
        ph.install("req", PHType.INT, MUST_DEFINE)
        ph.parse_string("other = 2\n")
        with pytest.raises(ParseError):
            ph.check_must_defines("test")

    def test_header_terminator(self, tmp_path):
        f = tmp_path / "withbin.dat"
        f.write_bytes(b'a = 5\n\x02\n\x00\x01BINARYDATA')
        ph = ParseHeader()
        ph.install("a", PHType.INT, MUST_DEFINE)
        offset = ph.read_header(f)
        assert ph["a"] == 5
        assert f.read_bytes()[offset:] == b"\x00\x01BINARYDATA"

    def test_include(self, tmp_path):
        (tmp_path / "inner.par").write_text("b = 7\n")
        main = tmp_path / "main.par"
        main.write_text('a = 1\ninclude "inner.par"\n')
        ph = ParseHeader()
        ph.install("a", PHType.INT, DONT_CARE)
        ph.install("b", PHType.INT, DONT_CARE)
        ph.read_header(main)
        assert ph["a"] == 1 and ph["b"] == 7


class TestParameters:
    def test_from_file(self, tmp_path):
        p = Parameters.from_file(write_par(tmp_path))
        assert p.ppd == 64
        assert p.np == 64**3
        assert p.separation == pytest.approx(100.0 / 64)
        assert p.fundamental == pytest.approx(2 * 3.141592653589793 / 100.0)
        assert p.nyquist == pytest.approx(3.141592653589793 / (100.0 / 64))
        assert p.narray == 2

    def test_version_required(self, tmp_path):
        with pytest.raises(ParameterError, match="ZD_Version"):
            Parameters.from_file(write_par(tmp_path, drop=["ZD_Version"]))

    def test_np_perfect_cube(self, tmp_path):
        with pytest.raises(ParameterError, match="perfect cube"):
            Parameters.from_file(write_par(tmp_path, {"NP": 100}))

    def test_sigma_xor(self, tmp_path):
        with pytest.raises(ParameterError, match="Pk_sigma"):
            Parameters.from_file(
                write_par(tmp_path, {"ZD_Pk_sigma": 0.0})
            )
        with pytest.raises(ParameterError, match="Pk_sigma"):
            Parameters.from_file(
                write_par(tmp_path, {"ZD_Pk_sigma_ratio": 1.0})
            )

    def test_pk_source_xor(self, tmp_path):
        with pytest.raises(ParameterError, match="Pk_filename"):
            Parameters.from_file(
                write_par(tmp_path, {"ZD_Pk_powerlaw_index": -1.0})
            )
        ok = Parameters.from_file(
            write_par(
                tmp_path, {"ZD_Pk_powerlaw_index": -1.0}, drop=["ZD_Pk_filename"]
            )
        )
        assert ok.Pk_powerlaw_index == -1.0

    def test_qplt_needs_rv_format(self, tmp_path):
        with pytest.raises(ParameterError, match="RV"):
            Parameters.from_file(
                write_par(
                    tmp_path,
                    {"ZD_qPLT": 1, "ZD_PLT_filename": "eig", "ICFormat": "Zeldovich"},
                )
            )

    def test_v1_numblock_scaling(self, tmp_path):
        p = Parameters.from_file(
            write_par(tmp_path, {"ZD_Version": 1, "ZD_k_cutoff": 2.0})
        )
        assert p.numblock == 4  # 2 * k_cutoff, rounded

    def test_narray_variants(self, tmp_path):
        assert Parameters.from_file(write_par(tmp_path, {"ZD_qdensity": 2})).narray == 1
        assert (
            Parameters.from_file(
                write_par(tmp_path, {"ZD_qPLT": 1, "ZD_PLT_filename": "eig"})
            ).narray
            == 4
        )

    def test_k_cutoff_range(self, tmp_path):
        with pytest.raises(ParameterError, match="k_cutoff"):
            Parameters.from_file(write_par(tmp_path, {"ZD_k_cutoff": 0.5}))

    def test_extra_keys_tolerated(self, tmp_path):
        par = write_par(tmp_path)
        with par.open("a") as f:
            f.write("SomeAbacusOnlyKey = 17\nOmega_DE = 0.7\n")
        Parameters.from_file(par)
