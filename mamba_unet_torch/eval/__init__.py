"""Evaluation: host-side (numpy/scipy) metrics and volume inference, and
the Mamba-LM loglikelihood evaluator."""
