"""Multi-device support of the port.  So far only the device health probe
(``multihost.health_check``) that the HTTP front end's ``/health`` reads."""
