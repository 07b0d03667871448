"""The port's YAML reader against ``yaml.safe_load``.

``core.yaml_subset`` reads the subset of YAML the shipped configs use, with
PyYAML's YAML 1.1 scalar rules, and ``core.config.load_config`` uses it on
every host: the card's machine has no pyyaml.
"""

import json
import math
import os
import re
import subprocess
import sys
import textwrap

import pytest
import yaml

from deeplip_tpu_torch.core.config import load_audio_config, load_config, load_fusion_config
from deeplip_tpu_torch.core.yaml_subset import YAMLSubsetError, load_yaml, loads_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = [os.path.join(REPO, "conf", name) for name in ("audio_config.yaml",
                                                          "fusion_config.yaml")]

EDGES = textwrap.dedent("""\
    # a comment line
    none_string: None
    null_word: null
    tilde: ~
    empty:
    yes_word: yes
    off_word: Off
    true_word: TRUE
    small_float: 0.00001
    exponent_without_dot: 1e-5
    exponent_without_sign: 1.0e5
    exponent_with_sign: 1.5e+3
    leading_dot: .5
    negative_inf: -.inf
    octal: 012
    hex: 0x1F
    binary: 0b101
    separators: 1_000
    plus: +5
    sexagesimal: 1:30
    sexagesimal_float: 1:30.5
    ints: [200, 400]
    nested: [[-2, -1, 0, 1, 2], [0], []]
    mixed_flow: [a, 'b c', "d", 1.5, null, true]
    single_quoted: 'it''s # not a comment'
    double_quoted: "tab\\there \\u00e9 \\x41 \\"q\\""
    hash_inside: path/with#hash
    colon_inside: a:b
    url: http://host:8080/x   # trailing comment
    'quoted key': 3
    1: int key
    true: bool key
    block:
      - 1
      - two
      - [3, 4]
      - key: v
        other: 2
      -
    compact:
    - x
    - y
    nested_block:
    - - -2
      - -1
    - - 0
    - - - 1
    deep:
      deeper:
        deepest: [a, b]
      empty_map:
    last: end
    """)


@pytest.mark.parametrize("path", SHIPPED, ids=os.path.basename)
def test_shipped_configs_read_as_pyyaml_reads_them(path):
    with open(path) as fh:
        want = yaml.safe_load(fh)
    assert load_yaml(path) == want
    assert load_config(path).to_dict() == want


def test_edge_cases_follow_pyyaml():
    want = yaml.safe_load(EDGES)
    got = loads_yaml(EDGES)
    assert repr(got) == repr(want)
    # the YAML 1.1 rules the shipped files touch, spelled out
    assert got["none_string"] == "None" and got["null_word"] is None and got["empty"] is None
    assert got["small_float"] == 1e-5 and got["exponent_without_dot"] == "1e-5"
    assert got["ints"] == [200, 400] and all(type(v) is int for v in got["ints"])
    assert math.isinf(got["negative_inf"]) and got["sexagesimal"] == 90


@pytest.mark.parametrize("text,what", [
    ("a: &anchor 1\n", "node '&anchor 1'"),
    ("a: *alias\n", "node '*alias'"),
    ("a: !!str 1\n", "node '!!str 1'"),
    ("a: |\n  text\n", "node '|'"),
    ("a: {b: 1}\n", "node '{b: 1}'"),
    ("a: [1,\n  2]\n", "flow list over several lines"),
    ("a: 2001-12-14\n", "date"),
    ("a: b\n  c\n", "indented deeper"),
    ("---\na: 1\n", "document marker"),
    ("a:\n\t- 1\n", "tab"),
    ("a: 1\njust text\n", "without 'key: value'"),
])
def test_lines_outside_the_subset_name_the_file_and_line(tmp_path, text, what):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(YAMLSubsetError, match=re.escape(what)) as err:
        load_config(str(path))
    assert re.search(re.escape(str(path)) + r":\d+: ", str(err.value))


def test_configs_load_with_yaml_blocked(tmp_path):
    """In an interpreter where ``import yaml`` fails, both shipped configs
    load, and equal what pyyaml reads here."""
    want = {}
    for path in SHIPPED:
        with open(path) as fh:
            want[os.path.basename(path)] = yaml.safe_load(fh)
    probe = textwrap.dedent(f"""
        import json, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name == "yaml" or name.startswith("yaml."):
                    raise ImportError("yaml is blocked")
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        try:
            import yaml
            sys.exit("yaml imported")
        except ImportError:
            pass
        from deeplip_tpu_torch.core.config import load_audio_config, load_fusion_config
        out = {{"audio_config.yaml": load_audio_config({SHIPPED[0]!r}).to_dict(),
               "fusion_config.yaml": load_fusion_config({SHIPPED[1]!r}).to_dict()}}
        print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-I", "-c", probe], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == json.loads(json.dumps(want))


def test_section_loaders_fill_empty_sections(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("model:\n  arch: etdnn\ntest:\n")
    for load in (load_audio_config, load_fusion_config):
        cfg = load(str(path))
        assert cfg.test == {} and cfg.data == {} and cfg.train == {}
        assert cfg.model.arch == "etdnn"
