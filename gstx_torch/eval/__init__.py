"""Ranking evaluation: the generative (candidate log-likelihood) and the
discriminative (NSP probability) evaluators and the VisDial metrics."""
