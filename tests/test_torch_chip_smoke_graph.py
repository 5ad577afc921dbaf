"""chip_smoke.dot_nodes: the nodes of a CUDA graph's DOT file
(cudaGraphDebugDotPrint, verbose), which the script's exact-kernel checks
read instead of a profiler trace."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import HEAD_KERNEL_NAMES, dot_nodes  # noqa: E402


def _kernel(i: int, func: str, grid: str = r"\{32,4,2\},256,230472") -> str:
    return (f'"graph_1_node_{i}"[style="bold" shape="record" label="{{KERNEL\n'
            f"| {{ID | {i} (topoId: {i}) | {func}\\<\\<\\<{grid}\\>\\>\\>}}\n"
            "| {{node handle | func handle} | {0x000000000AC0FB20 | 0x000000000A214470}}\n"
            "| {cooperative | 0}\n| {priority | 0}\n}\"];\n\n")


def _dot(*nodes: str, edges: str = "") -> str:
    return ('digraph dot {\nsubgraph cluster_1 {\nlabel="graph_1" graph[style="dashed"];\n'
            + "".join(nodes) + edges + "}\n}\n")


ADD = ("_ZN2at6native29vectorized_elementwise_kernelILi8ENS0_21CUDAFunctorOnSelf_addIN3c108"
       "BFloat16EEESt5arrayIPcLm2EEEEviT0_T1_")


def test_kernels_by_head_name_and_others_by_function():
    text = _dot(_kernel(0, "_Z22flash_attn_pair_kernelILi512EEv11FwdPairArgs"),
                _kernel(1, ADD, "4096,128,0"),
                _kernel(2, "_Z26flash_attn_pair_lse_kernelILi512EEv11FwdPairArgs"),
                _kernel(3, ADD, "4096,128,0"),
                edges='"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];\n')
    assert dot_nodes(text) == {"flash_attn_pair_kernel": 1, "flash_attn_pair_lse_kernel": 1,
                               ADD: 2}


@pytest.mark.parametrize("name", sorted(HEAD_KERNEL_NAMES))
def test_every_head_kernel_is_named_by_its_longest_match(name):
    text = _dot(_kernel(0, f"_Z{len(name)}{name}ILi256ELb1EEv7FwdArgs"))
    assert dot_nodes(text) == {name: 1}


def test_copies_and_memsets_count_and_empty_nodes_do_not():
    text = _dot(_kernel(0, "adaln_norm_kernel", r"\{2,1,1\},256,0"),
                '"graph_1_node_1"[style="bold" shape="record" label="{MEMSET\n'
                '| {ID | 1 (topoId: 1) | MEMSET}\n}"];\n\n',
                '"graph_1_node_2"[style="bold" shape="record" label="{MEMCPY\n'
                '| {ID | 2 (topoId: 2) | MEMCPY}\n}"];\n\n',
                '"graph_1_node_3"[style="solid" shape="record" label="{EMPTY\n'
                '| {ID | 3 (topoId: 3)}\n}"];\n\n')
    assert dot_nodes(text) == {"adaln_norm_kernel": 1, "MEMSET": 1, "MEMCPY": 1}


def test_a_file_without_nodes_raises():
    with pytest.raises(AssertionError, match="names no node"):
        dot_nodes(_dot())
