"""PyTorch port, xLSTM blocks: the mLSTM's parallel (prefill) and
recurrent (decode) forms with the prefill -> decode state handoff, and
the sLSTM's sequential scan from its initial state and from a given one,
against the JAX reference (``repro/models/xlstm.py``) on the same seeded
weights and inputs: float32 within 1e-5 of the reference output's
largest magnitude, every state leaf too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch, reduced as jax_reduced
from repro.models import layers as JL
from repro.models import xlstm as JX
from repro_torch.configs import get_arch, reduced
from repro_torch.models import xlstm as X

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want).max()) / scale
    assert err <= tol, err


def _states_close(got, want):
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])


def _case(specs_fn, seed, s, **cfg_kw):
    cj, ct = (dataclasses.replace(red(get("xlstm-1.3b")),
                                  compute_dtype="float32", **cfg_kw)
              for get, red in ((jax_get_arch, jax_reduced),
                               (get_arch, reduced)))
    p = JL.init_params(specs_fn(cj), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    # gate weights and biases that are not near zero (their init is)
    for name in ("w_igate", "w_fgate", "b_igate", "b_fgate", "b_in",
                 "r_z", "r_i", "r_f", "r_o"):
        if name in p:
            p[name] = jnp.asarray(rng.normal(0, 0.3, p[name].shape),
                                  jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = rng.normal(0, 1.0, (2, s, cj.d_model)).astype(np.float32)
    return cj, ct, p, tp, x


def _t_state(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


@pytest.mark.parametrize("s,q_chunk", [(1, 1024), (24, 1024), (32, 8)],
                         ids=["one-token", "one-chunk", "four-chunks"])
def test_mlstm_parallel_form_and_final_state_match_reference(s, q_chunk):
    """The parallel form over one query chunk or several, and the final
    (C, n, m) it hands to decode."""
    cj, ct, p, tp, x = _case(JX.mlstm_specs, 0, s)
    out_j, st_j = JX.mlstm_apply(p, cj, jnp.asarray(x), q_chunk=q_chunk)
    out_t, st_t = X.mlstm_apply(tp, ct, torch.from_numpy(x),
                                q_chunk=q_chunk)
    _close(out_t, out_j)
    _states_close(st_t, st_j)


def test_mlstm_prefill_then_recurrent_steps_match_reference():
    """The prefill -> decode handoff: three recurrent steps from the
    parallel form's final state."""
    cj, ct, p, tp, x = _case(JX.mlstm_specs, 1, 12)
    _, st_j = JX.mlstm_apply(p, cj, jnp.asarray(x))
    _, st_t = X.mlstm_apply(tp, ct, torch.from_numpy(x))
    rng = np.random.default_rng(2)
    for _ in range(3):
        x1 = rng.normal(0, 1.0, (2, 1, cj.d_model)).astype(np.float32)
        out_j, st_j = JX.mlstm_apply(p, cj, jnp.asarray(x1), state=st_j)
        out_t, st_t = X.mlstm_apply(tp, ct, torch.from_numpy(x1),
                                    state=st_t)
        _close(out_t, out_j)
        _states_close(st_t, st_j)


def test_mlstm_recurrent_step_from_a_given_state_matches_reference():
    cj, ct, p, tp, x = _case(JX.mlstm_specs, 3, 1)
    rng = np.random.default_rng(4)
    specs = X.mlstm_state_specs(ct, 2)
    st = {k: rng.normal(0, 0.5, shape).astype(np.float32)
          for k, (shape, _) in specs.items()}
    out_j, st_j = JX.mlstm_apply(p, cj, jnp.asarray(x),
                                 state={k: jnp.asarray(v)
                                        for k, v in st.items()})
    out_t, st_t = X.mlstm_apply(tp, ct, torch.from_numpy(x),
                                state=_t_state(st))
    _close(out_t, out_j)
    _states_close(st_t, st_j)


def test_mlstm_refuses_a_prompt_off_the_query_chunk():
    """Past one query chunk the length must be a multiple of it: the
    reference asserts, the port raises ``ValueError`` (it does not
    pad)."""
    _, ct, _, tp, x = _case(JX.mlstm_specs, 5, 12)
    with pytest.raises(ValueError, match="multiple"):
        X.mlstm_apply(tp, ct, torch.from_numpy(x), q_chunk=8)


@pytest.mark.parametrize("given", [False, True],
                         ids=["initial-state", "given-state"])
def test_slstm_scan_matches_reference(given):
    """The sequential scan from ``slstm_init_state`` (n = 1e-6) or from
    a given state (a zero cache: n = 0, guarded by max(n, 1e-6)), then
    one more token from the state it ends in."""
    cj, ct, p, tp, x = _case(JX.slstm_specs, 6, 10)
    st_j = st_t = None
    if given:
        zero = np.zeros((2, cj.d_model), np.float32)
        st_j = {k: jnp.asarray(zero) for k in ("h", "c", "n", "m")}
        st_t = _t_state(st_j)
    out_j, st_j = JX.slstm_apply(p, cj, jnp.asarray(x), state=st_j)
    out_t, st_t = X.slstm_apply(tp, ct, torch.from_numpy(x), state=st_t)
    _close(out_t, out_j)
    _states_close(st_t, st_j)
    x1 = x[:, :1] * 0.5
    out_j, st_j = JX.slstm_apply(p, cj, jnp.asarray(x1), state=st_j)
    out_t, st_t = X.slstm_apply(tp, ct, torch.from_numpy(x1), state=st_t)
    _close(out_t, out_j)
    _states_close(st_t, st_j)


def test_slstm_initial_state_matches_reference():
    cj = jax_reduced(jax_get_arch("xlstm-1.3b"))
    ct = reduced(get_arch("xlstm-1.3b"))
    want = JX.slstm_init_state(cj, 3)
    got = X.slstm_init_state(ct, 3)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    specs = X.slstm_state_specs(ct, 3)
    assert {k: v[0] for k, v in specs.items()} == \
        {k: v.shape for k, v in JX.slstm_state_specs(cj, 3).items()}
