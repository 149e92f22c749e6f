"""Full-waveform inversion: objective, regularization, CG loop, runner."""
