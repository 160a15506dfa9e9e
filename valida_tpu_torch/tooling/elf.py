"""Minimal ELF loader (port of `elf/src/lib.rs` semantics, no external
deps): extracts text/data/rodata sections from 32- or 64-bit little-endian
ELF objects, computes the initial pc = min text addr / 24, and collects
static data words for the static-data chip.

Counterpart of valida_tpu/tooling/elf.py.
"""

from __future__ import annotations

import dataclasses
import struct

from ..core.program import ProgramROM, INSTRUCTION_ELEMENTS
from ..core.word import bytes_to_u32

SHT_PROGBITS = 1
SHT_NOBITS = 8
SHF_WRITE = 0x1
SHF_ALLOC = 0x2
SHF_EXECINSTR = 0x4


@dataclasses.dataclass
class Program:
    code: ProgramROM
    data: dict  # addr -> u32 word value
    initial_program_counter: int


def load_executable_file(file: bytes) -> Program:
    if file[:4] == b"\x7fELF":
        return load_elf_object_file(file)
    return Program(
        code=ProgramROM.from_machine_code(file),
        data={},
        initial_program_counter=0,
    )


def _section_headers(file: bytes):
    ei_class = file[4]
    if file[5] != 1:
        raise ValueError("big-endian ELF unsupported")
    if ei_class == 1:  # 32-bit
        e_shoff = struct.unpack_from("<I", file, 0x20)[0]
        e_shentsize = struct.unpack_from("<H", file, 0x2E)[0]
        e_shnum = struct.unpack_from("<H", file, 0x30)[0]
        for i in range(e_shnum):
            off = e_shoff + i * e_shentsize
            (_name, sh_type, sh_flags, sh_addr, sh_offset, sh_size) = (
                struct.unpack_from("<IIIIII", file, off)
            )
            yield sh_type, sh_flags, sh_addr, sh_offset, sh_size
    elif ei_class == 2:  # 64-bit
        e_shoff = struct.unpack_from("<Q", file, 0x28)[0]
        e_shentsize = struct.unpack_from("<H", file, 0x3A)[0]
        e_shnum = struct.unpack_from("<H", file, 0x3C)[0]
        for i in range(e_shnum):
            off = e_shoff + i * e_shentsize
            (_name, sh_type, sh_flags, sh_addr, sh_offset, sh_size) = (
                struct.unpack_from("<IIQQQQ", file, off)
            )
            yield sh_type, sh_flags, sh_addr, sh_offset, sh_size
    else:
        raise ValueError("bad ELF class")


def load_elf_object_file(file: bytes) -> Program:
    text_sections = []
    data_sections = []
    for sh_type, sh_flags, sh_addr, sh_offset, sh_size in _section_headers(file):
        content = file[sh_offset : sh_offset + sh_size]
        if sh_type == SHT_PROGBITS and sh_flags == (SHF_ALLOC | SHF_WRITE):
            data_sections.append((sh_addr, content))
        elif sh_type == SHT_PROGBITS and sh_flags in (SHF_ALLOC, 0x32):
            data_sections.append((sh_addr, content))  # rodata
        elif sh_type == SHT_PROGBITS and sh_flags == (SHF_ALLOC | SHF_EXECINSTR):
            text_sections.append((sh_addr, content))

    if not text_sections:
        raise ValueError("no text sections in ELF")

    initial_pc = min(
        addr // (INSTRUCTION_ELEMENTS * 4) for addr, _c in text_sections
    )
    code_size = max(addr + len(c) for addr, c in text_sections)
    code = bytearray(code_size)
    for addr, content in text_sections:
        code[addr : addr + len(content)] = content

    data = {}
    for addr, content in data_sections:
        content = bytes(content) + b"\x00" * (-len(content) % 4)
        for i in range(len(content) // 4):
            b4 = content[i * 4 : i * 4 + 4]
            # file bytes map directly into the big-endian Word slots
            # (elf/src/lib.rs:88-97)
            data[addr + i * 4] = bytes_to_u32(b4)

    return Program(
        code=ProgramROM.from_machine_code(bytes(code)),
        data=data,
        initial_program_counter=initial_pc,
    )
