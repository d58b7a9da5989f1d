"""pAirZero core, ported: seeded ZO (zo), OTA aggregation (ota), the
analog Transport (transport), DP accountant (dp), Theorem-3 power control
(power_control), the round body (pairzero), the loop executor (engine) and
the run driver (fedsim)."""
