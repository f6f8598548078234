"""Polynomial zonotopes over the static k-monomial basis."""
