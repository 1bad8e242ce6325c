"""Public-cloud discovery adapters — recorded API responses → snapshots.

Port copy of deepflow_tpu/controller/cloud_adapters.py.

The reference ships one adapter per provider (server/controller/cloud/
aliyun/, aws/, …), each paging the provider SDK and normalizing into
the common resource model the recorder diffs. No cloud API is reachable
from this environment, so these adapters consume *recorded* API
response documents (the same JSON the SDKs return — fixtures in tests,
operator-supplied dumps in production) and perform the same
normalization:

  regions → region, zones → az, VPCs → l3_epc, vSwitches/subnets →
  subnet, instances → device(type=vm), ENIs → vinterfaces with MAC+IPs.

Numeric ids (epc_id, subnet_id, l3_device_id…) are recorder-allocated;
vinterface rows carry `_refs` markers that CloudTask.poll resolves
against the recorder's (domain, kind, uid) → id map — the same
two-poll settling used for K8s pod vifs.

Reference: cloud/aliyun/aliyun.go (GetCloudData assembly), vm.go,
network.go, vpc.go; cloud/aws/aws.go, vinterface_and_ip.go.
"""

from __future__ import annotations

DEVICE_TYPE_VM = 1


def _mac_int(mac: str) -> int:
    try:
        return int(mac.replace(":", "").replace("-", ""), 16)
    except ValueError:
        return 0


def _aliyun_list(doc: dict, outer: str, inner: str) -> list:
    """Aliyun responses nest lists as {"Vpcs": {"Vpc": [...]}}."""
    v = doc.get(outer, {})
    return v.get(inner, []) if isinstance(v, dict) else (v or [])


class AliyunPlatform:
    """Aliyun (ECS/VPC) API-response documents → recorder snapshot.

    `responses` maps API names to their recorded JSON bodies:
      DescribeRegions, DescribeZones, DescribeVpcs, DescribeVSwitches,
      DescribeInstances, DescribeNetworkInterfaces.
    """

    def __init__(self, responses: dict, *, domain: str = "aliyun"):
        self.domain = domain
        self._r = responses

    def update(self, responses: dict) -> None:
        self._r = responses

    def snapshot(self) -> dict:
        r = self._r
        res: dict[str, list] = {
            "region": [], "az": [], "l3_epc": [], "subnet": [], "device": [],
        }
        for reg in _aliyun_list(r.get("DescribeRegions", {}), "Regions", "Region"):
            res["region"].append({
                "uid": reg["RegionId"],
                "name": reg.get("LocalName", reg["RegionId"]),
            })
        for z in _aliyun_list(r.get("DescribeZones", {}), "Zones", "Zone"):
            res["az"].append({
                "uid": z["ZoneId"],
                "name": z.get("LocalName", z["ZoneId"]),
                "region": z.get("RegionId", ""),
            })
        for vpc in _aliyun_list(r.get("DescribeVpcs", {}), "Vpcs", "Vpc"):
            res["l3_epc"].append({
                "uid": vpc["VpcId"],
                "name": vpc.get("VpcName") or vpc["VpcId"],
                "cidr": vpc.get("CidrBlock", ""),
                "region": vpc.get("RegionId", ""),
            })
        for sw in _aliyun_list(r.get("DescribeVSwitches", {}), "VSwitches", "VSwitch"):
            res["subnet"].append({
                "uid": sw["VSwitchId"],
                "name": sw.get("VSwitchName") or sw["VSwitchId"],
                "cidr": sw.get("CidrBlock", ""),
                "epc": sw.get("VpcId", ""),
                "az": sw.get("ZoneId", ""),
            })
        inst_vpc: dict[str, str] = {}
        for inst in _aliyun_list(r.get("DescribeInstances", {}), "Instances", "Instance"):
            vpc_uid = inst.get("VpcAttributes", {}).get("VpcId", "")
            inst_vpc[inst["InstanceId"]] = vpc_uid
            res["device"].append({
                "uid": inst["InstanceId"],
                "name": inst.get("InstanceName") or inst["InstanceId"],
                "type": "vm",
                "epc": vpc_uid,
                "az": inst.get("ZoneId", ""),
                "state": inst.get("Status", ""),
            })
        vifs = []
        for eni in _aliyun_list(
            r.get("DescribeNetworkInterfaces", {}),
            "NetworkInterfaceSets", "NetworkInterfaceSet",
        ):
            ips = [
                p["PrivateIpAddress"]
                for p in _aliyun_list(eni, "PrivateIpSets", "PrivateIpSet")
                if p.get("PrivateIpAddress")
            ]
            primary = eni.get("PrivateIpAddress")
            if primary and primary not in ips:
                ips.insert(0, primary)
            inst = eni.get("InstanceId", "")
            vifs.append({
                "mac": _mac_int(eni.get("MacAddress", "")),
                "ips": ips,
                "l3_device_type": DEVICE_TYPE_VM,
                "_refs": [
                    ("epc_id", "l3_epc", eni.get("VpcId") or inst_vpc.get(inst, "")),
                    ("subnet_id", "subnet", eni.get("VSwitchId", "")),
                    ("l3_device_id", "device", inst),
                ],
            })
        return {"resources": res, "vinterfaces": vifs}


class AwsPlatform:
    """AWS (EC2/VPC) API-response documents → recorder snapshot.

    `responses` maps boto3-shaped API names to bodies: DescribeRegions,
    DescribeAvailabilityZones, DescribeVpcs, DescribeSubnets,
    DescribeInstances (Reservations form).
    """

    def __init__(self, responses: dict, *, domain: str = "aws"):
        self.domain = domain
        self._r = responses

    def update(self, responses: dict) -> None:
        self._r = responses

    @staticmethod
    def _tag_name(obj: dict, default: str) -> str:
        for t in obj.get("Tags", []):
            if t.get("Key") == "Name" and t.get("Value"):
                return t["Value"]
        return default

    def snapshot(self) -> dict:
        r = self._r
        res: dict[str, list] = {
            "region": [], "az": [], "l3_epc": [], "subnet": [], "device": [],
        }
        for reg in r.get("DescribeRegions", {}).get("Regions", []):
            res["region"].append({
                "uid": reg["RegionName"], "name": reg["RegionName"],
            })
        for z in r.get("DescribeAvailabilityZones", {}).get("AvailabilityZones", []):
            res["az"].append({
                "uid": z["ZoneName"], "name": z["ZoneName"],
                "region": z.get("RegionName", ""),
            })
        for vpc in r.get("DescribeVpcs", {}).get("Vpcs", []):
            res["l3_epc"].append({
                "uid": vpc["VpcId"],
                "name": self._tag_name(vpc, vpc["VpcId"]),
                "cidr": vpc.get("CidrBlock", ""),
            })
        for sn in r.get("DescribeSubnets", {}).get("Subnets", []):
            res["subnet"].append({
                "uid": sn["SubnetId"],
                "name": self._tag_name(sn, sn["SubnetId"]),
                "cidr": sn.get("CidrBlock", ""),
                "epc": sn.get("VpcId", ""),
                "az": sn.get("AvailabilityZone", ""),
            })
        vifs = []
        for resv in r.get("DescribeInstances", {}).get("Reservations", []):
            for inst in resv.get("Instances", []):
                res["device"].append({
                    "uid": inst["InstanceId"],
                    "name": self._tag_name(inst, inst["InstanceId"]),
                    "type": "vm",
                    "epc": inst.get("VpcId", ""),
                    "az": inst.get("Placement", {}).get("AvailabilityZone", ""),
                    "state": inst.get("State", {}).get("Name", ""),
                })
                for eni in inst.get("NetworkInterfaces", []):
                    ips = [
                        p["PrivateIpAddress"]
                        for p in eni.get("PrivateIpAddresses", [])
                        if p.get("PrivateIpAddress")
                    ] or ([inst["PrivateIpAddress"]]
                          if inst.get("PrivateIpAddress") else [])
                    vifs.append({
                        "mac": _mac_int(eni.get("MacAddress", "")),
                        "ips": ips,
                        "l3_device_type": DEVICE_TYPE_VM,
                        "_refs": [
                            ("epc_id", "l3_epc",
                             eni.get("VpcId") or inst.get("VpcId", "")),
                            ("subnet_id", "subnet",
                             eni.get("SubnetId") or inst.get("SubnetId", "")),
                            ("l3_device_id", "device", inst["InstanceId"]),
                        ],
                    })
        return {"resources": res, "vinterfaces": vifs}
