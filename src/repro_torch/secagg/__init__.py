"""Privacy subsystem (reference: ``repro/secagg/``): simulated secure
aggregation and client-level DP, host numpy as in the reference.

- ``field``     fixed-point encoding into a modular field (exact sums)
- ``masking``   pairwise/self PRG masks + Shamir-share accounting
- ``protocol``  the 4-phase round, dropout recovery, the server's private
                aggregation
- ``dp``        DP-FedAvg clipping/noise + subsampled-Gaussian RDP accountant
"""
