"""The general generators and drivers of traffic. A traffic file
(``portbench/traffic/<mix>.json``) names its driver by ``"driver"``; the
driver reads every parameter of the mix from that file."""
