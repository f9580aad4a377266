"""Archive loading on the shared PSRFITS codec."""
