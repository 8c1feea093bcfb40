"""Tools of the port: the frame-chain perf lab (``perf_lab``), the
end-to-end haul driver (``bench_e2e``), the synthetic inputs both use
(``synth``) and the A/B walls of checkouts (``ab_walls``)."""
