"""Runtime self-management: the doctor-driven remediation loop
(``runtime.remediation``)."""
