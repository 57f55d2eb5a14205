"""The ctypes argument lists of the port's kernel entries against the C
signatures they bind, checked on the CPU.

``ops/lstm_cuda.py``, ``ops/bilstm_cuda.py`` and ``ops/poweriter_cuda.py``
declare each ``dn_*`` entry's arguments by hand (``_ARGTYPES``). A list that disagrees with its
``extern "C"`` signature in ``csrc/*.cu`` loads and calls without complaint
and passes every argument after the first mismatch in the wrong place, and
only the card would show it; here each list is read against the signature
in the source.
"""

import ctypes
import re
from pathlib import Path

import pytest

from dinunet_implementations_tpu_torch.ops import bilstm_cuda as tb
from dinunet_implementations_tpu_torch.ops import lstm_cuda as tl
from dinunet_implementations_tpu_torch.ops import poweriter_cuda as tp

CSRC = Path(tl.__file__).resolve().parents[1] / "csrc"

ENTRIES = [(lib, "dn_" + name, types) for name, (lib, types) in tl._ARGTYPES.items()]
ENTRIES += [(lib, entry, types) for (lib, entry), types in tb._ARGTYPES.items()]
ENTRIES += [(lib, "dn_" + name, types) for name, (lib, types) in tp._ARGTYPES.items()]


def _c_param_types(lib: str, entry: str) -> list:
    """The ctypes type of each parameter of ``int <entry>(...)`` in
    ``csrc/<lib>.cu``: a pointer, ``long long``, ``int`` or ``float``."""
    src = (CSRC / f"{lib}.cu").read_text()
    m = re.search(rf"^int {entry}\(([^)]*)\)", src, re.MULTILINE)
    assert m, f"no C entry {entry} in csrc/{lib}.cu"
    out = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split()[:-1]) + ("*" if "*" in param.split()[-1] else "")
        if "*" in decl:
            out.append(ctypes.c_void_p)
        elif decl.replace("const ", "") == "long long":
            out.append(ctypes.c_longlong)
        elif decl.replace("const ", "") == "float":
            out.append(ctypes.c_float)
        else:
            assert decl.replace("const ", "") == "int", f"{entry}: unexpected parameter {param!r}"
            out.append(ctypes.c_int)
    return out


@pytest.mark.parametrize("lib,entry,types", ENTRIES, ids=[e for _, e, _ in ENTRIES])
def test_argtypes_match_the_c_signature(lib, entry, types):
    assert types == _c_param_types(lib, entry)


def test_every_entry_of_the_lstm_sources_is_bound():
    """Each ``int dn_*`` entry of the recurrence sources has its list."""
    bound = {(lib, entry) for lib, entry, _ in ENTRIES}
    for lib in ("lstm_fwd", "lstm_bwd", "bilstm_fwd", "bilstm_bwd"):
        for entry in re.findall(r"^int (dn_\w+)\(", (CSRC / f"{lib}.cu").read_text(), re.MULTILINE):
            assert (lib, entry) in bound, f"{entry} of csrc/{lib}.cu has no ctypes list"


#: the occupancy entry beside each BPTT launch: K4's bf16 instance reads a
#: bf16 dhs and K6's an f32 constant, so each has its own
BPTT_OCCUPANCY = {"dn_lstm_bwd": "dn_lstm_bwd_max_active_clusters",
                  "dn_bilstm_pool_bwd": "dn_bilstm_bwd_max_active_clusters",
                  "dn_bilstm_bwd": "dn_bilstm_k4_max_active_clusters"}


@pytest.mark.parametrize("lib,entry", [("lstm_bwd", "dn_lstm_bwd"),
                                       ("bilstm_bwd", "dn_bilstm_pool_bwd"),
                                       ("bilstm_bwd", "dn_bilstm_bwd")])
def test_the_bptt_entries_take_a_route_record_and_a_phase_clock(lib, entry):
    """K2, K6 and K4 take their route (cluster or stream) and geometry as a
    record, and the cluster route's phase clock, before the stream; each has
    an occupancy entry beside it."""
    src = (CSRC / f"{lib}.cu").read_text()
    params = re.search(rf"^int {entry}\(([^)]*)\)", src, re.MULTILINE).group(1).split(",")
    assert [p.split()[-1] for p in params[-3:]] == ["geom", "prof", "stream"]
    bound = {e for _, e, _ in ENTRIES}
    assert entry in bound
    occupancy = BPTT_OCCUPANCY[entry]
    assert occupancy in bound
    assert re.search(rf"^int {occupancy}\(", src, re.MULTILINE)


def test_every_entry_of_the_poweriter_source_is_bound():
    """K7's entries: the launch, which takes its route record and the
    staged route's phase clock before the stream, and the occupancy query
    of the staged kernel."""
    src = (CSRC / "poweriter.cu").read_text()
    entries = set(re.findall(r"^int (dn_\w+)\(", src, re.MULTILINE))
    assert entries == {"dn_poweriter", "dn_poweriter_max_active_blocks"}
    assert entries <= {e for lib, e, _ in ENTRIES if lib == "poweriter"}
    params = re.search(r"^int dn_poweriter\(([^)]*)\)", src, re.MULTILINE).group(1).split(",")
    assert [p.split()[-1] for p in params[-3:]] == ["geom", "prof", "stream"]
    # the route record is read up to its last field and no further
    read = {int(k) for k in re.findall(r"\bgeom\[(\d+)\]", src)}
    assert read == set(range(tp._GEOM_LEN))
