"""The readings behind the one-ulp witness of ``test_torch_lm_mesh.py``:
every check of a split profile (``tp``, ``serve_tp``) whose error passes
its tolerance, with the tolerance, the unmeshed function's own shifts
over the witness's draws (every weight moved one ulp) and the error over
the largest of them (held at ``WITNESS_K``).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/witness_readings.py
"""

import test_torch_lm_mesh as T
from repro_torch.sharding import partition

CASES = (
    [(f"train step tp 2x4 {a}", T.test_meshed_train_step_equals_unmeshed,
      (a, "tp", (2, 4))) for a in T.ARCHS]
    + [(f"compressed step tp {a}", T.test_meshed_compressed_step_equals_unmeshed, (a,))
       for a in ("h2o-danube-1.8b", "qwen2-moe-a2.7b", "seamless-m4t-large-v2")]
    + [("batch of 1, bf16", T.test_a_batch_that_does_not_divide_is_counted_once, ()),
       ("MoE routing forward", T.test_moe_routing_groups_and_balance_loss_are_the_whole_batchs,
        ())]
    + [(f"served {a}", T.test_meshed_prefill_and_decode_equal_unmeshed, (a,)) for a in T.ARCHS]
    + [("recurrentgemma decode", T.test_serve_tp_decode_of_recurrentgemma_steps_equal_unmeshed,
        ())]
)


def main() -> None:
    rows, hold = [], T.Witness.hold

    def record(self, key, err, tol):
        hold(self, key, err, tol)
        if err > tol:
            rows.append((key, err, tol, [d[key] for d in self.draws]))

    T.Witness.hold = record
    for name, test, args in CASES:
        rows.clear()
        try:
            test(*args, partition.set_profile)
            verdict = "held"
        except AssertionError as e:
            verdict = f"FAILED {e}"
        finally:
            partition.set_profile("tp")
        line = f"{name}: {len(rows)} checks past the tolerance"
        if rows:
            key, err, tol, draws = max(rows, key=lambda r: r[1] / max(r[3]))
            line += (f"; the largest ratio {err / max(draws):.2f} at {key}: {err:.3g} past "
                     f"{tol:.0e}, one-ulp shifts {[f'{d:.3g}' for d in draws]}")
        print(f"{line}; {verdict}")


if __name__ == "__main__":
    main()
