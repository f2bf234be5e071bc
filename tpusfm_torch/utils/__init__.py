"""Host-side helpers: metrics, synthetic scenes, events, results and geo-registration."""
