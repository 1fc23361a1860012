"""The reference's five examples on the port (``examples/`` of the JAX
package): ``quickstart``, ``mixed_precision_study``, ``serve_demo``,
``train_lm`` and ``fault_tolerance_demo``.

Each runs as ``python -m repro_torch.examples.<name> [--device cpu]``
on the card by default, prints what the reference's example prints, line
for line, and has a ``main(device=None, ...)`` that returns its numbers
as a dict (with the run's own phase list where a number depends on the
wall clock, so that it can be attributed again on the same timeline).
Each example's own checks raise.
"""
