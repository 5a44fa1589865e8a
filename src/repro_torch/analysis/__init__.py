"""Static plan verification and traffic cross-audit."""
