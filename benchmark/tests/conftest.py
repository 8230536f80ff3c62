import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import json  # noqa: E402

from benchmark import harness  # noqa: E402

TINY = {"num_variants": 3000, "num_samples": 24}
SEED = 2**31 + 91


def tiny_cell(name: str) -> harness.Cell:
    """``name``'s cell at a size the CPU tests hold (fewer planted pairs)."""
    cell = harness.load_cell(name)
    cell.config.update(TINY)
    if cell.traffic.get("plant_pairs"):
        cell.traffic["plant_pairs"] = 3
    return cell



FOUR_RANKS = "g1k_chr22_4gpu.device_keep2"
# cells whose files the benchmark keeps but BENCHMARK.json does not hold yet:
# their configuration and traffic, found by name as load_cell finds them
HELD = {"g1k_chr22.device_keep2": ("g1k_chr22", "device_keep2"),
        FOUR_RANKS: ("g1k_chr22_4gpu", "device_keep2")}


def cell_named(name: str) -> harness.Cell:
    """``tiny_cell(name)``, for a cell of ``BENCHMARK.json`` or of ``HELD``
    (with every metric of ``BENCHMARK.json``), so that the keep-two job and
    the harness's ranks stay tested."""
    if name not in HELD:
        return tiny_cell(name)
    config, traffic = HELD[name]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(
        name, 0, json.loads((ROOT / f"benchmark/configs/{config}.json").read_text()),
        json.loads((ROOT / f"benchmark/traffic/{traffic}.json").read_text()),
        spec["end_to_end"], spec["per_layer"])
    cell.config.update(TINY)
    cell.chips = cell.config["chips"]
    return cell
