"""The layout's device cache (rsem_tpu_torch/ops/layout.py, counterpart of
rsem_tpu/ops/layout.py's _DEV_CACHE) on the CPU. The CPU itself is never
cached (torch.as_tensor shares the numpy buffer there), so the lookups
below go to the meta device, which allocates nothing, and the bare
_dev_cached to CUDA device keys that no call ever touches. A repeat lookup
serves the same tensors; another device or width, a replaced attribute, an
in-place edit of a sampled element and the container's collection each
miss or evict; run_em gives the same counts with and without the cache
cleared."""

import copy
import gc

import numpy as np
import pytest
import torch

from rsem_tpu_torch.engine.em import EMConfig, run_em
from rsem_tpu_torch.ops import layout
from rsem_tpu_torch.ops.layout import (
    HitsDevice,
    ReadsDevice,
    RefDevice,
    clear_device_cache,
    device_cache_bytes,
)
from rsem_tpu_torch.testing import synthetic_dataset

META = torch.device("meta")


@pytest.fixture(autouse=True)
def _empty_cache():
    clear_device_cache()
    yield
    clear_device_cache()


@pytest.fixture(scope="module")
def dataset():
    return synthetic_dataset(n_reads=600, M=30, read_len=36, tx_len=300,
                             seed=4)


def test_repeat_lookup_serves_the_same_tensors(dataset):
    ref, bundle, _spec, _model = dataset
    assert device_cache_bytes() == 0
    refd = RefDevice.from_reference(ref, META)
    reads = ReadsDevice.from_arrays(bundle.reads, META)
    hits = HitsDevice.from_arrays(bundle.hits, META)
    assert refd.codes.device.type == "meta"
    assert RefDevice.from_reference(ref, META) is refd
    assert ReadsDevice.from_arrays(bundle.reads, META) is reads
    assert HitsDevice.from_arrays(bundle.hits, META) is hits
    want = sum(t.numel() * t.element_size()
               for lay in (refd, reads, hits) for t in lay
               if isinstance(t, torch.Tensor))
    assert device_cache_bytes() == want > 0
    clear_device_cache()
    assert device_cache_bytes() == 0
    assert HitsDevice.from_arrays(bundle.hits, META) is not hits


def test_other_device_or_width_misses(dataset):
    _ref, bundle, _spec, _model = dataset
    reads = ReadsDevice.from_arrays(bundle.reads, META)
    wide = ReadsDevice.from_arrays(bundle.reads, META, width=50)
    assert wide is not reads and wide.codes.shape[1] == 50
    assert ReadsDevice.from_arrays(bundle.reads, META, width=50) is wide
    hits = bundle.hits
    built = []

    def build():
        built.append(1)
        return (torch.zeros(3),)

    arrays = (hits.rid, hits.sid)
    for index in (0, 1, 0, 1):
        layout._dev_cached(hits, ("probe",), torch.device("cuda", index),
                           arrays, build)
    assert len(built) == 2


def test_cpu_is_never_cached(dataset):
    ref, bundle, _spec, _model = dataset
    a = RefDevice.from_reference(ref, torch.device("cpu"))
    b = RefDevice.from_reference(ref, torch.device("cpu"))
    assert a is not b and device_cache_bytes() == 0
    assert a.codes.data_ptr() == ref.codes.ctypes.data  # shared buffer


def test_replaced_attribute_misses(dataset):
    _ref, bundle, _spec, _model = dataset
    hits = copy.copy(bundle.hits)
    first = HitsDevice.from_arrays(hits, META)
    hits.sid = hits.sid.copy()  # same values, another array
    second = HitsDevice.from_arrays(hits, META)
    assert second is not first
    assert HitsDevice.from_arrays(hits, META) is second


@pytest.mark.parametrize("where", ["first", "last", "inner"])
def test_edit_of_a_sampled_element_misses(dataset, where):
    ref, _bundle, _spec, _model = dataset
    ref = copy.copy(ref)
    ref.codes = ref.codes.copy()
    n = ref.codes.size
    assert n > layout.FINGERPRINT_SAMPLE  # a strided sample, not all
    sampled = np.linspace(0, n - 1, layout.FINGERPRINT_SAMPLE).astype(
        np.int64)
    i = {"first": 0, "last": n - 1, "inner": int(sampled[1234])}[where]
    first = RefDevice.from_reference(ref, META)
    ref.codes[i] = (ref.codes[i] + 1) % 5
    second = RefDevice.from_reference(ref, META)
    assert second is not first
    assert RefDevice.from_reference(ref, META) is second


def test_edit_outside_the_sample_is_not_seen(dataset):
    """The contract's limit: the containers are immutable; an in-place edit
    of an element the fingerprint does not sample is served stale."""
    ref, _bundle, _spec, _model = dataset
    ref = copy.copy(ref)
    ref.codes = ref.codes.copy()
    n = ref.codes.size
    sampled = set(np.linspace(0, n - 1, layout.FINGERPRINT_SAMPLE).astype(
        np.int64).tolist())
    i = next(j for j in range(1, n) if j not in sampled)
    first = RefDevice.from_reference(ref, META)
    ref.codes[i] = (ref.codes[i] + 1) % 5
    assert RefDevice.from_reference(ref, META) is first


def test_collection_evicts(dataset):
    _ref, bundle, _spec, _model = dataset
    reads = copy.copy(bundle.reads)
    ReadsDevice.from_arrays(reads, META)
    assert device_cache_bytes() > 0
    del reads
    gc.collect()
    assert device_cache_bytes() == 0
    assert not layout._DEV_CACHE


def test_run_em_with_and_without_clearing(dataset):
    """Two run_em calls on one bundle, the cache cleared between them or
    not, give equal counts."""
    ref, bundle, _spec, model0 = dataset
    cfg = EMConfig(max_round=30)
    a = run_em(copy.deepcopy(model0), ref, bundle, cfg,
               need_posteriors=False, device="cpu")
    b = run_em(copy.deepcopy(model0), ref, bundle, cfg,
               need_posteriors=False, device="cpu")
    clear_device_cache()
    c = run_em(copy.deepcopy(model0), ref, bundle, cfg,
               need_posteriors=False, device="cpu")
    assert a.rounds == b.rounds == c.rounds
    np.testing.assert_allclose(b.counts, a.counts, rtol=1e-5)
    np.testing.assert_allclose(c.counts, a.counts, rtol=1e-5)
