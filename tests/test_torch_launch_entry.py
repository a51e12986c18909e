"""The kernels' C launch entries on the host: the dynamic shared-memory
attribute is a device's, so each entry sets it once on every device it
launches on, not once a process.

Every entry — the generated one (``stencil3d.launch_entry``, shared by the
block and the sweep kernels), ``swa.cu``, ``swa_mma.cu``, ``swa_bwd.cu``
and ``swa_bwd_mma.cu`` — is compiled by the host C++ compiler with its kernel
launches (``<<<...>>>``) turned into a counted call and the CUDA runtime
calls it makes replaced by host versions: a current device that the test
sets, and ``cudaFuncSetAttribute`` recorded by (device, kernel,
attribute).  The entry is called on device 0 twice, on device 1 twice and
on device 0 again: each (kernel, attribute) must be set exactly once on
each of the two devices, and every call must launch.
"""

import ctypes
import re

import pytest
import torch

from repro_torch.apps import pw_advection, tracer_advection
from repro_torch.core.schedule import auto_plan
from repro_torch.kernels import stencil3d, swa

from test_torch_kernel_emulated import SHIM, _helpers
from test_torch_swa import MMA_SHIM, _split_helpers, _host_library
from test_torch_sweep_kernel import _calls

# the runtime calls of a launch entry, on the host
RUNTIME_SHIM = r"""
#include <set>
#include <tuple>
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
                         cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
enum { cudaSharedmemCarveoutMaxShared = 100 };
typedef void* cudaStream_t;
static int emu_device = 0;
static std::vector<std::tuple<int, const void*, int>> emu_attrs;
static int emu_launches = 0;
inline cudaError_t cudaGetDevice(int* d) { *d = emu_device; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F* fn, cudaFuncAttribute a, int) {
  emu_attrs.emplace_back(emu_device, reinterpret_cast<const void*>(fn),
                         (int)a);
  return cudaSuccess;
}
template <class... A> void emu_kernel_launch(A&&...) { ++emu_launches; }
extern "C" void emu_set_device(int d) { emu_device = d; }
extern "C" int emu_launch_count() { return emu_launches; }
extern "C" int emu_attr_calls(int d) {
  int n = 0;
  for (auto& a : emu_attrs) n += std::get<0>(a) == d;
  return n;
}
extern "C" int emu_attr_distinct(int d) {
  std::set<std::pair<const void*, int>> s;
  for (auto& a : emu_attrs)
    if (std::get<0>(a) == d) s.emplace(std::get<1>(a), std::get<2>(a));
  return (int)s.size();
}
"""


def _host_entry(src: str) -> str:
    """``src`` as host C++: shared memory from the shim, and each
    ``kernel<<<cfg>>>(args)`` a counted call."""
    src = src.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = emu_smem;")
    return re.sub(r"([\w]+(?:<\w+>)?)<<<.*?>>>\(", r"emu_kernel_launch(\1, ",
                  src, flags=re.S)


def _generated(calls):
    src = stencil3d.bind(calls).source
    head, rest = src.split(stencil3d.BLOCK_HELPERS)
    return head + _helpers() + rest


def _block_source():
    p = tracer_advection()
    grid = (256, 256, 128)
    plan = auto_plan(p, grid)
    call = stencil3d.build_group_call(p, plan.groups[0], plan.block, grid)
    assert call.smem_bytes > 48 * 1024
    return _generated([call]), call.c_argtypes()


def _stream_source():
    calls = _calls(pw_advection, "zero", (512, 256, 256), torch.float32, 1, 1)
    assert calls[0].cta.smem_bytes > 48 * 1024
    return _generated(calls), calls[0].c_argtypes()


def _swa_source(dtype):
    src = swa.kernel_source(dtype, 80)
    shim = ""
    if dtype == torch.bfloat16:
        head, _, tail = _split_helpers(src)
        src, shim = head + tail, MMA_SHIM
    return src, swa._ARGTYPES, shim


def _swa_bwd_mma_source():
    head, _, tail = _split_helpers(swa.backward_source(torch.bfloat16, 80))
    return head + tail, swa._BWD_ARGTYPES[torch.bfloat16]


# (name, entry, source and argument types, (kernel, attribute) pairs set)
ENTRIES = {
    "block": ("g0_launch", _block_source, 2),
    "stream": ("g0_launch", _stream_source, 2),
    "swa_f32": ("swa_launch", lambda: _swa_source(torch.float32)[:2], 1),
    "swa_mma": ("swa_launch", lambda: _swa_source(torch.bfloat16)[:2], 2),
    "swa_bwd": ("swa_bwd_launch",
                lambda: (swa.backward_source(torch.float32, 80),
                         swa._BWD_ARGTYPES[torch.float32]), 2),
    "swa_bwd_mma": ("swa_bwd_launch", lambda: _swa_bwd_mma_source(), 2),
}


def _arg(t):
    """A value of ctypes type ``t`` that every entry takes: null pointers,
    ones for the sizes (one batch element, one KV head)."""
    if t is ctypes.c_void_p:
        return None
    return t(1)


@pytest.mark.parametrize("which", sorted(ENTRIES))
def test_shared_memory_attribute_is_set_once_per_device(which):
    entry, make, n_attrs = ENTRIES[which]
    src, argtypes = make()
    shim = SHIM + RUNTIME_SHIM
    if which in ("swa_mma", "swa_bwd_mma"):
        shim += MMA_SHIM
    lib = _host_library(_host_entry(src), shim, f"entry_{which}")
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    for dev in (0, 0, 1, 1, 0):
        lib.emu_set_device(dev)
        assert fn(*(_arg(t) for t in argtypes)) == 0
    kernels = 2 if which.startswith("swa_bwd") else 1
    assert lib.emu_launch_count() == 5 * kernels
    for dev in (0, 1):
        assert lib.emu_attr_calls(dev) == lib.emu_attr_distinct(dev) \
            == n_attrs, dev
    lib.emu_set_device(64)
    assert fn(*(_arg(t) for t in argtypes)) != 0
