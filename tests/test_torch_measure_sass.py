"""The latency floor's instruction count (``kernels/measure.py
step_instructions``) on a fixed ``cuobjdump -sass`` listing.

The listing holds the three kernels of a recording build: the derived pass
(no main loop: not counted) and the flight kernel in float32 and float64.
Each flight kernel has a main loop (0x20-0xd0) around an RK4 stage loop
(0x30-0x80); inside the stage loop a branch skips two instructions in
float32 and one in float64; after it an event branch skips two, and a call
to a subroutine (0x120) returns to the next instruction. The fewest
instructions of a step: the stage loop's shortest cycle (4 in float32, 5 in
float64) ``stages - 1`` times, plus the shortest walk from its head out of
it and back: 0x30, 0x40, (0x60 in float64,) 0x70, 0x80, 0x90, 0xc0, 0xd0,
0x20 (8, 9). The whole loop body would count 12 + 3 x 6 = 30 at 4 stages.
"""

import pytest

from erpl_monte_carlo_sim_tpu_torch.kernels.measure import latency_floor, step_instructions

FLIGHT_BODY = """\
        /*0000*/                   LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
                                                                       /* 0x000e300000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                  /* 0x0000000000007919 */
        /*0020*/                   MOV R2, RZ ;                        /* 0x000000ff00027202 */
        /*0030*/                   FADD R3, R2, 1 ;                    /* 0x3f80000002037421 */
        /*0040*/              @!P0 BRA {skip} ;                        /* 0x0000000000008947 */
        /*0050*/                   FMUL R4, R3, R3 ;                   /* 0x0000000303047220 */
        /*0060*/                   FMUL R4, R4, R3 ;                   /* 0x0000000304047220 */
        /*0070*/                   FADD R5, R4, R3 ;                   /* 0x0000000304057221 */
        /*0080*/               @P1 BRA 0x30 ;                          /* 0xfffffffc00001947 */
        /*0090*/               @P2 BRA 0xc0 ;                          /* 0x0000000000002947 */
        /*00a0*/                   FADD R6, R5, R5 ;                   /* 0x0000000505067221 */
        /*00b0*/                   FADD R6, R6, R5 ;                   /* 0x0000000506067221 */
        /*00c0*/                   CALL.REL.NOINC 0x120 ;              /* 0x0000000000007944 */
        /*00d0*/              @!P3 BRA P4, 0x20 ;                      /* 0xfffffff400008947 */
        /*00e0*/                   EXIT ;                              /* 0x000000000000794d */
        /*00f0*/                   BRA 0xf0;                           /* 0xfffffffc00fc7947 */
        /*0100*/                   NOP;                                /* 0x0000000000007918 */
        /*0110*/                   NOP;                                /* 0x0000000000007918 */
        /*0120*/                   MUFU.RSQ R7, R6 ;                   /* 0x0000000600077308 */
        /*0130*/                   RET.REL.NODEC R20 0x0 ;             /* 0xfffffffc14007950 */
"""

LISTING = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : _ZN50_GLOBAL__N__0_flight_summary_cu_021record_derived_kernelENS_6LeavesENS_6TablesENS_3RecEiii
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;             /* 0x0000000102027810 */
        /*0020*/               @P0 BRA 0x10 ;                          /* 0xfffffffc00000947 */
        /*0030*/                   EXIT ;                              /* 0x000000000000794d */
		..........

		Function : _ZN50_GLOBAL__N__0_flight_summary_cu_021flight_summary_kernelENS_6LeavesENS_6TablesENS_3CfgEPfPiiNS_3RecE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
""" + FLIGHT_BODY.format(skip="0x70") + """\
		..........

		Function : _ZN50_GLOBAL__N__0_flight_summary_cu_021flight_summary_kernelENS_6LeavesENS_6TablesENS_3CfgEPdPiiNS_3RecE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
""" + FLIGHT_BODY.format(skip="0x60") + """\
		..........
"""


@pytest.mark.parametrize("stages,want", [(4, {"f32": 20, "f64": 24}),
                                         (2, {"f32": 12, "f64": 14}),
                                         (1, {"f32": 8, "f64": 9})],
                         ids=["rk4", "rk2", "one-stage"])
def test_step_instructions_is_the_shortest_step(stages, want):
    """Each branch takes its cheaper side, the stage loop its shortest cycle
    ``stages`` times, the subroutine is not entered, and the derived pass
    is not a flight kernel."""
    assert step_instructions(LISTING, stages) == want


def test_latency_floor_issues_one_instruction_a_clock():
    """1,980 steps of 1,000 instructions at 1,980 MHz: 1 ms."""
    assert latency_floor(1980, 1000, 1980.0) == pytest.approx(1.0, rel=1e-12)
