"""Adam as one CUDA kernel (``trainer/optimizer.py``'s ``adam_fused``,
``ops/rasterize/csrc/adam.cu``) against the plain version ``adam_plain``.

On the CPU: ``adam_update`` takes the plain body, the kernel's wrapper
checks every tensor and learning rate before it changes anything, and a
model's parameters are contiguous whatever layout they load from. On the
card (marker ``cuda``): three consecutive steps of the kernel against the
plain version on the card, over the Gaussian model's six parameter shapes
at 1,001 and 250,003 Gaussians (neither a multiple of 4) with the cameras'
``rot`` and ``trans``, learning rates as floats and as a 0-d tensor, one
parameter without a gradient and one that starts 4 bytes past a 16-byte
boundary, every p, m and v within a relative norm gap of 1e-6 (the plain
ops may round a product before its sum where the kernel fuses them, so
bits are not asked); the update captured in a CUDA graph and replayed
three times equal to three eager steps, the count advancing; the wrapper
raising on a float64 or non-contiguous CUDA tensor; one launch counted a
call. Run there from the repository root with

    python -m pytest --noconftest -m cuda -s tests/test_torch_adam_kernel.py

(``--noconftest`` because the suite's conftest imports JAX, which this file
does not).
"""
import pytest

torch = pytest.importorskip("torch")

from reduced_3dgs_torch.ops.rasterize import _build, launches  # noqa: E402
from reduced_3dgs_torch.trainer import optimizer  # noqa: E402

# The Gaussian model's parameters, by name: their shapes after N.
SHAPES = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3), "scaling": (3,),
          "rotation": (4,), "opacity": (1,)}
# The learned camera delta's (CameraTrainer._slot).
CAMERA = {"rot": (4,), "trans": (3,)}
STEPS = 3
# Relative norm gap of p, m and v between the kernel and the plain version.
REL_GAP = 1e-6


def _state(shapes, n, count, seed, device, grad_less=(), shifted=()):
    """(params, AdamState, a gradient per step) with random values: moments
    as after some steps (v > 0), parameters without a gradient in
    ``grad_less``, and those of ``shifted`` starting one float past their
    storage's (16-byte aligned) start."""
    gen = torch.Generator().manual_seed(seed)

    def rand(shape, name, scale=1.0):
        x = (scale * torch.randn(shape, generator=gen)).to(device)
        if name in shifted:
            flat = torch.empty(x.numel() + 1, device=device)
            flat[1:] = x.reshape(-1)
            return flat[1:].view(shape)
        return x

    params, m, v, grads = {}, {}, {}, []
    for name, tail in shapes.items():
        shape = (n, *tail) if n else tail
        params[name] = torch.nn.Parameter(rand(shape, name))
        m[name] = rand(shape, name, 1e-3)
        v[name] = rand(shape, name, 1e-3).square()
    for _ in range(STEPS):
        grads.append({name: None if name in grad_less else rand(p.shape, name, 1e-2)
                      for name, p in params.items()})
    state = optimizer.AdamState(count=optimizer.adam_count(count, device), m=m, v=v)
    return params, state, grads


def _copy(params, state):
    p = {k: torch.nn.Parameter(t.detach().clone()) for k, t in params.items()}
    return p, optimizer.AdamState(count=state.count.clone(),
                                  m={k: t.clone() for k, t in state.m.items()},
                                  v={k: t.clone() for k, t in state.v.items()})


def _set_grads(params, grads):
    for k, p in params.items():
        p.grad = None if grads[k] is None else grads[k].clone()


def _gaps(params, state, ref_params, ref_state):
    """{(name, which): |a - b| / |b|} over p, m and v (0 where both are 0)."""
    out = {}
    for k in params:
        for which, a, b in (("p", params[k], ref_params[k]), ("m", state.m[k], ref_state.m[k]),
                            ("v", state.v[k], ref_state.v[k])):
            a, b = a.detach(), b.detach()
            diff, norm = float((a - b).norm()), float(b.norm())
            out[(k, which)] = diff / norm if norm else diff
    return out


# ------------------------------------------------------------------ the CPU
def test_a_cpu_state_takes_the_plain_body():
    params, state, grads = _state(SHAPES, 5, 7, 1, "cpu", grad_less=("opacity",))
    ref_params, ref_state = _copy(params, state)
    lrs = {k: 1e-3 for k in params}
    before = optimizer.adam_fused.launches
    for g in grads:
        _set_grads(params, g)
        _set_grads(ref_params, g)
        optimizer.adam_update(params, state, lrs)
        optimizer.adam_plain(ref_params, ref_state, lrs)
    assert optimizer.adam_fused.launches == before
    assert int(state.count) == int(ref_state.count) == 7 + STEPS
    assert all(gap == 0 for gap in _gaps(params, state, ref_params, ref_state).values())


def _bad(case, device="cpu"):
    """A one-parameter state on ``device`` that the kernel does not take, by
    ``case``."""
    params, state, _ = _state({"a": (3,)}, 6, 0, 2, device)
    lrs = {"a": 0.1}
    p = params["a"]
    if case == "float64 parameter":
        params["a"] = torch.nn.Parameter(p.detach().double())
    elif case == "float64 moment":
        state.m["a"] = state.m["a"].double()
    elif case == "strided gradient":
        p.grad = torch.zeros(3, 6, device=device).t()
    elif case == "shape of v":
        state.v["a"] = state.v["a"].reshape(-1)
    elif case == "rate of two values":
        lrs["a"] = torch.tensor([0.1, 0.2], device=device)
    elif case == "float64 rate":
        lrs["a"] = torch.tensor(0.1, dtype=torch.float64, device=device)
    elif case == "int64 count":
        state.count = state.count.long()
    elif case == "nine parameters":
        for k in range(1, 9):
            params[f"a{k}"] = torch.nn.Parameter(p.detach().clone())
            state.m[f"a{k}"], state.v[f"a{k}"] = state.m["a"].clone(), state.v["a"].clone()
            lrs[f"a{k}"] = 0.1
    return params, state, lrs


@pytest.mark.parametrize("case", ["float64 parameter", "float64 moment", "strided gradient",
                                  "shape of v", "rate of two values", "float64 rate",
                                  "int64 count", "nine parameters"])
def test_the_kernel_wrapper_raises_before_it_changes_anything(case):
    params, state, lrs = _bad(case)
    before = {k: t.detach().clone() for k, t in params.items()}
    launched = optimizer.adam_fused.launches
    with pytest.raises(ValueError, match="adam_fused"):
        optimizer.adam_fused(params, state, lrs)
    assert int(state.count) == 0 and optimizer.adam_fused.launches == launched
    assert all(torch.equal(params[k].detach(), before[k]) for k in params)


def test_a_model_loaded_in_any_layout_holds_contiguous_parameters(tmp_path):
    """A PLY's SH rows load transposed; the parameters (and so their
    gradients) are contiguous all the same, as the kernel takes them."""
    import numpy as np

    from reduced_3dgs_torch.models.gaussian_model import GaussianModel
    rng = np.random.default_rng(5)
    n = 7
    params = {"xyz": rng.normal(size=(n, 3)), "features_dc": rng.normal(size=(n, 1, 3)),
              "features_rest": rng.normal(size=(n, 3, 15)).transpose(0, 2, 1),
              "opacity": rng.normal(size=(n, 1)), "scaling": rng.normal(size=(n, 3)),
              "rotation": rng.normal(size=(n, 4))}
    model = GaussianModel(3, device="cpu").load_numpy(params)
    path = str(tmp_path / "m.ply")
    model.save_ply(path)
    for loaded in (model, GaussianModel(3, device="cpu")):
        if loaded is not model:
            loaded.load_ply(path)
        assert all(p.is_contiguous() for p in loaded.param_dict().values())
        np.testing.assert_array_equal(loaded._features_rest.detach().numpy(),
                                      params["features_rest"].astype(np.float32))


# ------------------------------------------------------------------ the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    _build.load_library("adam")         # built and loaded before any capture
    return torch.device("cuda")


def _learning_rates(params, device):
    """xyz's as a 0-d tensor on the card (the schedule's), the others as
    floats of the trainer's sizes."""
    return {k: (torch.tensor(1.6e-4, device=device) if k == "xyz" else 2.5e-3 / (i + 1))
            for i, k in enumerate(params)}


@pytest.mark.cuda
@pytest.mark.parametrize("count", [0, 16_900])
@pytest.mark.parametrize("shapes, n", [(SHAPES, 1_001), (SHAPES, 250_003), (CAMERA, 0)],
                         ids=["gaussians-1001", "gaussians-250003", "camera"])
def test_card_kernel_against_plain(card, shapes, n, count):
    names = list(shapes)
    params, state, grads = _state(shapes, n, count, 3, card, grad_less=names[-1:],
                                  shifted=names[1:2])
    ref_params, ref_state = _copy(params, state)
    start = {k: p.detach().clone() for k, p in params.items()}
    lrs = _learning_rates(params, card)
    before = optimizer.adam_fused.launches
    for g in grads:
        _set_grads(params, g)
        _set_grads(ref_params, g)
        optimizer.adam_update(params, state, lrs)
        optimizer.adam_plain(ref_params, ref_state, lrs)
    torch.cuda.synchronize()
    assert optimizer.adam_fused.launches - before == STEPS
    assert int(state.count) == int(ref_state.count) == count + STEPS
    gaps = _gaps(params, state, ref_params, ref_state)
    assert max(gaps.values()) <= REL_GAP, {k: g for k, g in gaps.items() if g > REL_GAP}
    # Every parameter moves, the one without a gradient too (its m is not 0).
    assert [k for k in names if not torch.equal(params[k], start[k])] == names


@pytest.mark.cuda
def test_card_graph_replays_equal_eager_steps(card):
    """The update captured once and replayed three times, the gradients and
    xyz's rate copied into the captured tensors before each replay, equals
    three eager steps; the count advances at each replay, and each replay
    counts one launch."""
    params, state, grads = _state(SHAPES, 10_007, 100, 4, card, grad_less=("opacity",))
    eager_params, eager_state = _copy(params, state)
    lrs = _learning_rates(params, card)
    rates = [1.6e-4, 1.2e-4, 0.9e-4]
    _set_grads(params, grads[0])
    optimizer.adam_fused.launches = 0
    graph, _, _, tally, _, _ = launches.capture_graph(
        lambda: None, lambda: optimizer.adam_update(params, state, lrs), card)
    assert tally["adam_fused"] == 1 and optimizer.adam_fused.launches == 0
    assert int(state.count) == 100
    for step, g in enumerate(grads):
        for k, p in params.items():
            if g[k] is not None:
                p.grad.copy_(g[k])
        lrs["xyz"].fill_(rates[step])
        graph.replay()
        launches.add_replayed_launches(tally)
    eager_lrs = dict(lrs)
    for step, g in enumerate(grads):
        _set_grads(eager_params, g)
        eager_lrs["xyz"] = torch.tensor(rates[step], device=card)
        optimizer.adam_update(eager_params, eager_state, eager_lrs)
    torch.cuda.synchronize()
    assert int(state.count) == int(eager_state.count) == 100 + STEPS
    assert optimizer.adam_fused.launches == 2 * STEPS
    for k in params:
        assert torch.equal(params[k], eager_params[k]), k
        assert torch.equal(state.m[k], eager_state.m[k]) and torch.equal(state.v[k],
                                                                          eager_state.v[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64 parameter", "strided gradient"])
def test_card_wrapper_raises(card, case):
    params, state, lrs = _bad(case, card)
    with pytest.raises(ValueError, match="adam_fused"):
        optimizer.adam_update(params, state, lrs)
    assert int(state.count) == 0
