"""pAirZero core, ported: seeded ZO (zo), OTA aggregation (ota), the
analog, sign and perfect Transports (transport), DP accountant (dp),
Theorem-3/4 power control and its baselines (power_control), the round
body (pairzero), the loop and scan executors (engine) and the run loop
(fedsim)."""
